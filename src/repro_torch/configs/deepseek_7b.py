"""Arch config: deepseek-7b (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "deepseek-7b"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
