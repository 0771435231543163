"""Arch config: phi3-medium-14b (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "phi3-medium-14b"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
