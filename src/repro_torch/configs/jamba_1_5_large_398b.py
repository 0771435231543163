"""Arch config: jamba-1.5-large-398b (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "jamba-1.5-large-398b"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
