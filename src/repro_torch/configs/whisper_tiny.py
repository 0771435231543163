"""Arch config: whisper-tiny (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "whisper-tiny"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
