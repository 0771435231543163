"""Rotary position embedding with partial-fraction support (the PyTorch
counterpart of ``repro.models.rope``).

``rope_fraction`` < 1.0 rotates only the first ``fraction * head_dim`` dims
(chatglm3's "2d rope" applies rotary to half the head dim); fraction 0 is a
no-op. Pairs are interleaved (``x[..., 0::2]``, ``x[..., 1::2]``), not
split in halves, and angles are fp32.
"""
from __future__ import annotations

import torch


def rope_freqs(rot_dim: int, theta: float, device=None):
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float = 10000.0, fraction: float = 1.0):
    """x: [..., S, H, D]; positions: integer tensor broadcastable to
    [..., S]."""
    if fraction <= 0.0:
        return x
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)                # [rot/2]
    angles = positions[..., None, None].float() * freqs     # [...,S,1,rot/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)
