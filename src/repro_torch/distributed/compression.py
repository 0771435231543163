"""Gradient compression with error feedback, the PyTorch counterpart of
``repro.distributed.compression``.

int8 uniform quantization with a per-leaf scale; the quantization error is
carried in a residual state and added back next step (error feedback keeps
SGD convergence: Karimireddy et al. 2019). ``psum_quantized`` sums the
replicas' dequantized contributions, in bf16 as the reference's ``psum``,
by an all-reduce over a ``torch.distributed`` process group; with one
process, or with ``torch.distributed`` not initialised, the sum is the
one replica's contribution.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.train.optim import tree_leaves, tree_map

INT8_MAX = 127.0


def quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x float -> (int8 payload, fp32 scale); the scale is the per-tensor
    amax / 127 (1 for an all-zero tensor). x is divided by the scale, as
    in the reference (not multiplied by its reciprocal), and rounded half
    to even."""
    x32 = x.float()
    amax = x32.abs().max()
    scale = torch.where(amax > 0, amax / INT8_MAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize(q, scale):
    return q.float() * scale


def compress_with_feedback(grads, residual):
    """Returns (quantized tree with (q, scale) leaves, new residual); the
    residual has the layout of ``grads`` and keeps its own type."""
    def leaf(g, r):
        g32 = g.float() + r
        q, s = quantize(g32)
        return (q, s), (g32 - dequantize(q, s)).to(r.dtype)

    pairs = tree_map(leaf, grads, residual)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def psum_quantized(qtree, group=None):
    """Each leaf (q, scale) as its replica's dequantized contribution in
    bf16, summed over the process group's replicas by an all-reduce: a
    tree of bf16 sums. The identity on the contributions with one process
    or without an initialised process group."""
    def leaf(pair):
        q, s = pair
        contrib = (q.float() * s).to(torch.bfloat16)
        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size(group) > 1):
            dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
        return contrib

    return tree_map(leaf, qtree)


def compression_wire_bytes(params) -> dict:
    """Bytes on the wire per all-reduce: fp32 vs bf16 vs int8 payload."""
    n = sum(x.numel() for x in tree_leaves(params))
    return {"fp32": 4 * n, "bf16": 2 * n, "int8": n,
            "ratio_vs_fp32": 4.0}
