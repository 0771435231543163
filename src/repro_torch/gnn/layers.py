"""GNN layer operators on padded subgraph batches (the paper's §4.1 kernels),
in PyTorch.

Aggregation in both ACK execution modes:
  * dense mode — a [N,N] @ [N,f] batched matmul,
  * sg mode    — edge-list scatter-gather, ``index_add_`` at the
    destinations (the reference's ``segment_sum``).

The layer applies (``gcn_layer``, ``sage_layer``, ``gin_layer``,
``gat_layer``; ``LAYER_APPLY``) compose each layer from these in either
mode: the hand-written oracle the lowered program (``core.program``) is
held against, as in the reference.

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
# transform


def _ft(h, w, b=None):
    """Feature Transformation kernel (dense/systolic mode matmul)."""
    out = torch.matmul(h, w)
    return out if b is None else out + b


# ---------------------------------------------------------------------------
# layer applies. Each takes (params, h, batch, mode) -> h': the
# hand-written per-layer oracle that the lowered program (core.program)
# is held against


def _segment_sum(vals, seg, C: int, n: int):
    """Per subgraph c, out[c, i] = sum of vals[c, e] with seg[c, e] == i:
    vals [C, E, ...], seg [C, E] -> [C, n, ...]."""
    off = (torch.arange(C, device=vals.device) * n)[:, None]
    rest = vals.shape[2:]
    out = torch.zeros((C * n,) + rest, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, (seg + off).reshape(-1), vals.reshape((-1,) + rest))
    return out.reshape((C, n) + rest)


def _segment_max(vals, seg, C: int, n: int):
    """Per subgraph c, out[c, i] = max of vals[c, e] with seg[c, e] == i
    (-inf where none): vals [C, E, h], seg [C, E] -> [C, n, h]."""
    off = (torch.arange(C, device=vals.device) * n)[:, None]
    h = vals.shape[-1]
    out = torch.full((C * n, h), -math.inf, dtype=vals.dtype,
                     device=vals.device)
    idx = (seg + off).reshape(-1, 1).expand(-1, h)
    return out.scatter_reduce_(0, idx, vals.reshape(-1, h), "amax",
                               include_self=True).reshape(C, n, h)


def _mask_rows(out, batch):
    return out * batch["mask"][..., None]


def gcn_layer(p, h, batch, mode="dense", act=torch.relu):
    if mode == "dense":
        z = agg_dense(batch["adj"], h)
    else:
        z = agg_sg(batch["edge_src"], batch["edge_dst"], batch["edge_w"], h,
                   h.shape[1])
        # the self-loop term (normalized) is part of adj in dense mode; the
        # edges exclude it, so it is added here
        z = z + h * batch["self_w"][..., None]
    return _mask_rows(act(_ft(z, p["w"], p["b"])), batch)


def sage_layer(p, h, batch, mode="dense", act=torch.relu):
    if mode == "dense":
        z = agg_dense(batch["adj_mean"], h)
    else:
        z = agg_sg(batch["edge_src"], batch["edge_dst"],
                   batch["edge_w_mean"], h, h.shape[1])
    out = _ft(h, p["w_self"], p["b"]) + _ft(z, p["w_neigh"])
    return _mask_rows(act(out), batch)


def gin_layer(p, h, batch, mode="dense", act=torch.relu):
    if mode == "dense":
        z = agg_dense(torch.sign(batch["adj_mean"]), h)
    else:
        w = batch["edge_w"]
        z = agg_sg(batch["edge_src"], batch["edge_dst"],
                   torch.ones_like(w) * (w != 0), h, h.shape[1])
    z = (1.0 + p["eps"]) * h + z
    hidden = act(_ft(z, p["w1"], p["b1"]))
    return _mask_rows(act(_ft(hidden, p["w2"], p["b2"])), batch)


def gat_layer(p, h, batch, mode="dense", act=torch.nn.functional.elu,
              negative_slope=0.2):
    """Attention kernel (paper §4.1): e_ij from (h_i, h_j, W_att, a), then
    the masked softmax over incoming edges, then the weighted aggregation.
    Dense mode computes the full [N,N] score matrix; sg mode walks the
    edges, each node's self loop appended as an implicit (i, i) edge."""
    C, N, _ = h.shape
    nh, fh = p["a_src"].shape
    lrelu = torch.nn.functional.leaky_relu
    z = _ft(h, p["w"]).reshape(C, N, nh, fh)
    s_src = torch.einsum("cnhf,hf->cnh", z, p["a_src"])   # source term
    s_dst = torch.einsum("cnhf,hf->cnh", z, p["a_dst"])   # destination term
    if mode == "dense":
        # scores[c,h,i,j] for edge j->i (i = dst), structure incl. self loop
        e = s_dst.transpose(1, 2)[:, :, :, None] \
            + s_src.transpose(1, 2)[:, :, None, :]
        e = lrelu(e, negative_slope)
        struct = (torch.sign(batch["adj_mean"])
                  + torch.eye(N, dtype=h.dtype, device=h.device)) \
            * batch["mask"][:, None, :]
        emask = struct[:, None, :, :] > 0
        e = torch.where(emask, e, torch.full_like(e, NEG_INF))
        attn = torch.softmax(e, dim=-1)
        attn = torch.where(emask, attn, torch.zeros_like(attn))
        out = torch.einsum("chij,cjhf->cihf", attn, z)
    else:
        iota = torch.arange(N, device=h.device).expand(C, N)
        s_all = torch.cat([batch["edge_src"].long(), iota], dim=1)
        d_all = torch.cat([batch["edge_dst"].long(), iota], dim=1)
        v_all = torch.cat([(batch["edge_w"] != 0).to(h.dtype),
                           torch.ones((C, N), dtype=h.dtype,
                                      device=h.device)], dim=1)
        take = lambda t, idx: torch.gather(  # noqa: E731
            t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))
        e = lrelu(take(s_dst, d_all) + take(s_src, s_all), negative_slope)
        e = torch.where(v_all[..., None] > 0, e, torch.full_like(e, NEG_INF))
        m = _segment_max(e, d_all, C, N)
        ex = torch.exp(e - take(m, d_all)) * v_all[..., None]
        den = _segment_sum(ex, d_all, C, N)
        alpha = ex / torch.clamp(take(den, d_all), min=1e-20)
        zs = torch.gather(z, 1, s_all[..., None, None].expand(-1, -1, nh, fh))
        out = _segment_sum(alpha[..., None] * zs, d_all, C, N)
    out = out.reshape(C, N, nh * fh) + p["b"]
    return _mask_rows(act(out), batch)


LAYER_INITS = {"gcn": init_gcn_layer, "sage": init_sage_layer,
               "gin": init_gin_layer}
LAYER_APPLY = {"gcn": gcn_layer, "sage": sage_layer, "gin": gin_layer,
               "gat": gat_layer}


# ---------------------------------------------------------------------------
# readout


def readout(h, mask, kind="max"):
    """h [C,N,f] -> [C,f]. Paper: element-wise Max over the receptive
    field."""
    if kind == "target":
        return h[:, 0, :]
    if kind == "mean":
        s = torch.sum(h * mask[..., None], dim=1)
        return s / torch.clamp(torch.sum(mask, dim=1), min=1.0)[..., None]
    return h.masked_fill(mask[..., None] <= 0, NEG_INF).amax(dim=1)
