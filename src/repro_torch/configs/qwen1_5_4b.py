"""Arch config: qwen1.5-4b (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "qwen1.5-4b"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
