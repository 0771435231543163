"""Arch config: pixtral-12b (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "pixtral-12b"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
