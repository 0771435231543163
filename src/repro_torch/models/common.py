"""Shared model building blocks: dense init, norms, activations, casts.

The PyTorch counterpart of ``repro.models.common``. Models are functional:
``init_*`` returns nested dicts of tensors, the apply functions are pure
apart from the decode cache (see ``attention.decode_attention``). There is
no ``shard()`` hook yet: the port runs on one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers


def dense_init(gen, shape, dtype=torch.float32):
    """LeCun-normal (fan-in = ``shape[-2]``) init for projection matrices,
    drawn from the ``torch.Generator`` ``gen`` on its own device."""
    fan_in = shape[-2]
    w = torch.randn(shape, generator=gen, device=gen.device)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def embed_init(gen, shape, dtype=torch.float32):
    w = torch.randn(shape, generator=gen, device=gen.device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations


def rms_norm(x, scale, eps=1e-5):
    """Normalizes in fp32, casts back to x's type, then multiplies by
    ``scale`` (so a bf16 x with an fp32 scale gives fp32, as in JAX)."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale + bias


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# misc


def cast_tree(tree, dtype):
    """Every floating tensor of a nested dict cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def matmul(a, b):
    """``a @ b`` after promoting both to their common type, as ``jnp``'s
    ``@`` does (torch refuses mixed types)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return tree.numel()
