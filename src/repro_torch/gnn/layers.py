"""GNN layer operators on padded subgraph batches (the paper's §4.1 kernels),
in PyTorch.

Aggregation in both ACK execution modes:
  * dense mode — a [N,N] @ [N,f] batched matmul,
  * sg mode    — edge-list scatter-gather, ``index_add_`` at the
    destinations (the reference's ``segment_sum``).

Shapes: feats h [C, N, f]; adj/adj_mean [C, N, N] (row = destination);
mask [C, N]; edges (src, dst, w) [C, E]. All ops are batched over C
targets. Layer inits are LeCun-normal like the reference's, drawn from a
``torch.Generator`` (so their numbers differ from JAX's; tests carry the
reference's parameters across with ``gnn.model.params_from_jax``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# aggregation primitives (FA kernel, both modes)


def agg_dense(adj, h):
    """Feature aggregation as dense matmul: [C,N,N] @ [C,N,f]."""
    return torch.bmm(adj, h)


def agg_sg(src, dst, w, h, n):
    """Scatter-gather aggregation (Algorithm 4).

    Scatter: per edge, update = w * h[src]  (vector multiplier units)
    Gather:  index-add updates at dst       (accumulator units)
    Subgraph c's vertices are rows c*n..c*n+n-1 of one flat axis.
    """
    C, E = src.shape
    F = h.shape[-1]
    off = (torch.arange(C, device=h.device) * n)[:, None]
    upd = h.reshape(C * n, F)[(src.long() + off).reshape(-1)] \
        * w.reshape(-1, 1)                                      # Scatter
    out = torch.zeros((C * n, F), dtype=h.dtype, device=h.device)
    out.index_add_(0, (dst.long() + off).reshape(-1), upd)     # Gather
    return out.reshape(C, n, F)


# ---------------------------------------------------------------------------
# layer inits


def dense_init(gen: torch.Generator, shape, in_axis=-2,
               dtype=torch.float32):
    """LeCun-normal (fan-in) init used for all projection matrices."""
    return (torch.randn(shape, generator=gen) /
            math.sqrt(shape[in_axis])).to(dtype)


def init_gcn_layer(gen, f_in, f_out, dtype=torch.float32):
    return {"w": dense_init(gen, (f_in, f_out), dtype=dtype),
            "b": torch.zeros((f_out,), dtype=dtype)}


def init_sage_layer(gen, f_in, f_out, dtype=torch.float32):
    return {"w_self": dense_init(gen, (f_in, f_out), dtype=dtype),
            "w_neigh": dense_init(gen, (f_in, f_out), dtype=dtype),
            "b": torch.zeros((f_out,), dtype=dtype)}


def init_gin_layer(gen, f_in, f_out, dtype=torch.float32):
    return {"w1": dense_init(gen, (f_in, f_out), dtype=dtype),
            "b1": torch.zeros((f_out,), dtype=dtype),
            "w2": dense_init(gen, (f_out, f_out), dtype=dtype),
            "b2": torch.zeros((f_out,), dtype=dtype),
            "eps": torch.zeros((), dtype=dtype)}


def init_appnp_layer(gen, f_in, f_out, alpha=0.15, dtype=torch.float32):
    """APPNP: layer0 is the prediction MLP; inner layers are
    propagation-only (one teleport scalar; ``w``/``b`` ride along unused,
    as in the reference, so every layer has the same parameter names)."""
    return {"w": dense_init(gen, (f_in, f_out), dtype=dtype),
            "b": torch.zeros((f_out,), dtype=dtype),
            "teleport": torch.tensor(alpha - 1.0, dtype=dtype)}


def init_sgc_layer(gen, f_in, f_out, dtype=torch.float32):
    """SGC: ONE weight matrix total; inner layers' ``w`` rides along
    unused."""
    return {"w": dense_init(gen, (f_in, f_out), dtype=dtype)}


def init_gat_layer(gen, f_in, f_out, n_heads, dtype=torch.float32):
    if f_out % n_heads:
        raise ValueError(f"f_out={f_out} not divisible by n_heads={n_heads}")
    fh = f_out // n_heads
    return {"w": dense_init(gen, (f_in, f_out), dtype=dtype),
            "a_src": dense_init(gen, (n_heads, fh), in_axis=-1,
                                dtype=dtype),
            "a_dst": dense_init(gen, (n_heads, fh), in_axis=-1,
                                dtype=dtype),
            "b": torch.zeros((f_out,), dtype=dtype)}


# ---------------------------------------------------------------------------
# transform + readout


def _ft(h, w, b=None):
    """Feature Transformation kernel (dense/systolic mode matmul)."""
    out = torch.matmul(h, w)
    return out if b is None else out + b


def readout(h, mask, kind="max"):
    """h [C,N,f] -> [C,f]. Paper: element-wise Max over the receptive
    field."""
    if kind == "target":
        return h[:, 0, :]
    if kind == "mean":
        s = torch.sum(h * mask[..., None], dim=1)
        return s / torch.clamp(torch.sum(mask, dim=1), min=1.0)[..., None]
    return h.masked_fill(mask[..., None] <= 0, NEG_INF).amax(dim=1)
