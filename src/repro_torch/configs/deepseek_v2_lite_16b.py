"""Arch config: deepseek-v2-lite-16b (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "deepseek-v2-lite-16b"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
