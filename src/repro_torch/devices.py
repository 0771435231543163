"""Device resolution shared by the package's entry points: a CUDA device
with no card raises instead of running somewhere else."""
from __future__ import annotations

import torch


def resolve(device, allow_meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" with no card raises.
    "meta" (shapes and types, no memory) only where ``allow_meta``: the
    parameter and cache builders that the launch analysis calls."""
    dev = torch.device(device)
    if dev.type == "meta" and allow_meta:
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={str(device)!r}: cuda or cpu"
                         + (" or meta" if allow_meta else ""))
    return dev
