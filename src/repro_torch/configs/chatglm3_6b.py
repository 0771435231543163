"""Arch config: chatglm3-6b (see registry for the exact published numbers)."""
from repro_torch.configs.registry import get_config

ARCH = "chatglm3-6b"
CONFIG = get_config(ARCH)
REDUCED = get_config(ARCH, reduced=True)
