"""Grouped-query attention: the prefill, cross and decode paths, in
PyTorch (the counterpart of ``repro.models.attention``).

Shapes: hidden [B, S, D]; q [B, S, H, Dh]; k/v [B, S, Kh, Dh] with
H % Kh == 0, query head h reading KV head h // (H // Kh). The decode path
consumes a KV cache [B, S_max, Kh, Dh] and a position.

``impl`` selects the prefill's attention core: ``"cuda"`` hands it to
``kernels.flash_attention`` (the CUDA kernel for CUDA tensors, its plain
version on the CPU), ``"torch"`` runs the reference's plain path (the
naive S x S softmax, or the chunked one when ``chunk_q`` applies).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (dense_init, einsum, fit_merge,
                                       fit_split, masked_fill, matmul,
                                       shard)
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
IMPLS = ("cuda", "torch")


def init_attn(gen, n_layers, d_model, n_heads, n_kv, head_dim,
              qkv_bias=False, dtype=torch.float32):
    """wq/wk/wv/wo (+ zero biases) of ``n_layers`` layers, stacked on a
    leading axis and drawn at once."""
    L = n_layers
    p = {"wq": dense_init(gen, (L, d_model, n_heads * head_dim), dtype),
         "wk": dense_init(gen, (L, d_model, n_kv * head_dim), dtype),
         "wv": dense_init(gen, (L, d_model, n_kv * head_dim), dtype),
         "wo": dense_init(gen, (L, n_heads * head_dim, d_model), dtype)}
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((L, width * head_dim), dtype=dtype,
                                  device=gen.device)
    return p


def qkv(params, x, n_heads, n_kv, head_dim):
    B, S, _ = x.shape
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = fit_split(q, -1, n_heads).reshape(B, S, n_heads, head_dim)
    k = fit_split(k, -1, n_kv).reshape(B, S, n_kv, head_dim)
    v = fit_split(v, -1, n_kv).reshape(B, S, n_kv, head_dim)
    return q, k, v


def _per_query_head(t, heads: int):
    """KV ``t`` [B,S,Kh,Dh] repeated to ``heads`` heads, query head h
    reading KV head h // G; ``t`` itself when it has them."""
    B, S, Kh, Dh = t.shape
    if Kh == heads:
        return t
    return t[:, :, :, None].expand(B, S, Kh, heads // Kh, Dh).reshape(
        B, S, heads, Dh)


def _kv_heads(q, k):
    """The KV heads the core reads for ``q``: ``k`` itself, or, for a
    DTensor ``q`` whose head shards do not split into whole KV groups,
    ``k`` repeated to one head a query head, so the core runs on ``q``'s
    head shards (GSPMD shards both factors of the split, a DTensor dim
    sits on one mesh dim); the same scores either way."""
    if fit_split(q, 2, k.shape[2]) is q:
        return k
    return _per_query_head(k, q.shape[2])


def _grouped(q, Kh: int):
    """q [B,S,H,Dh] -> [B,S,Kh,G,Dh]. With one query head a KV head this
    is an unsqueeze, which leaves a DTensor's uneven head shards (H not a
    multiple of the model axis) in place; a reshape would gather them."""
    B, S, H, Dh = q.shape
    if Kh == H:
        return q.unsqueeze(3)
    return fit_split(q, 2, Kh).reshape(B, S, Kh, H // Kh, Dh)


def _ungrouped(o):
    """o [B,S,Kh,G,Dh] -> [B,S,Kh*G,Dh] (``_grouped``'s inverse)."""
    B, S, Kh, G, Dh = o.shape
    return o.squeeze(3) if G == 1 else o.reshape(B, S, Kh * G, Dh)


def gqa_scores(q, k):
    """q [B,Sq,H,Dh], k [B,Sk,Kh,Dh] -> fp32 scores [B,Kh,G,Sq,Sk]
    (products of the inputs' values, summed in fp32)."""
    B, Sq, H, Dh = q.shape
    k = _kv_heads(q, k)
    Kh = k.shape[2]
    qg = _grouped(q, Kh)
    s = einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    return s.div_(math.sqrt(Dh))


def gqa_out(probs, v):
    """probs [B,Kh,G,Sq,Sk], v [B,Sk,Kh,Dh] -> [B,Sq,H,Dh] in v's type
    (the probabilities are cast to v's type first, as in JAX)."""
    B, Kh, G, Sq, _ = probs.shape
    Dh = v.shape[-1]
    v = _per_query_head(v, Kh)
    o = einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return _ungrouped(o)


def chunked_gqa_attention(q, k, v, *, causal=True, block_q=1024):
    """Online attention in plain PyTorch: queries in blocks of
    ``block_q``, each seeing one [..., Bq, S] score tile.

    q [B,S,H,Dh]; k/v [B,S,Kh,Dh]. Returns [B,S,H,Dh]."""
    B, S, H, Dh = q.shape
    k, v = _kv_heads(q, k), _kv_heads(q, v)
    Kh = k.shape[2]
    G = H // Kh
    bq = min(block_q, S)
    if S % bq:
        raise ValueError(f"chunked_gqa_attention: S={S} is not a multiple "
                         f"of block_q={bq}")
    qg = _grouped(q, Kh).permute(0, 2, 3, 1, 4)              # [B,Kh,G,S,D]
    kt = k.permute(0, 2, 1, 3)                               # [B,Kh,S,D]
    vt = v.permute(0, 2, 1, 3)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))  # as JAX
    cols = torch.arange(S, device=q.device)
    blocks = []
    for i in range(S // bq):
        qb = qg[:, :, :, i * bq:(i + 1) * bq]
        s = einsum("bkgqd,bksd->bkgqs", qb.float(), kt.float())
        s.mul_(scale)
        if causal:
            rows = i * bq + torch.arange(bq, device=q.device)
            s = masked_fill(s, ~(rows[:, None] >= cols[None, :]), NEG_INF)
        p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
        num = einsum("bkgqs,bksd->bkgqd", p.to(vt.dtype), vt)
        den = p.sum(dim=-1, keepdim=True).to(vt.dtype)
        blocks.append(num / den.clamp_min(1e-20))
    o = torch.cat(blocks, dim=3)                             # [B,Kh,G,S,D]
    return _ungrouped(o.permute(0, 3, 1, 2, 4))


def _flash_core(q, k, v, causal):
    """q [B,S,H,Dh], k/v [B,S,Kh,Dh] through ``flash_attention``: heads
    to the front; the kernel reads KV head h // (H // Kh) for query head
    h itself."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return flash_attention(qt, kt, vt, causal=causal).transpose(1, 2)


def full_attention(params, x, *, n_heads, n_kv, head_dim, rope_theta=1e4,
                   rope_fraction=1.0, causal=True, positions=None,
                   chunk_q: int = 0, impl: str = "cuda"):
    """Prefill attention. Returns [B, S, D].

    ``impl="cuda"`` runs the core through ``flash_attention`` whatever
    ``chunk_q`` says; ``impl="torch"`` runs the naive S x S softmax, or
    the chunked path when ``chunk_q`` > 0 divides S into several blocks."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}, expected one of {IMPLS}")
    B, S, _ = x.shape
    q, k, v = qkv(params, x, n_heads, n_kv, head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta, rope_fraction)
    k = apply_rope(k, positions, rope_theta, rope_fraction)
    q = shard(q, ("batch", None, "heads", None))
    k = shard(k, ("batch", None, "kv_heads", None))
    v = shard(v, ("batch", None, "kv_heads", None))
    if impl == "cuda":
        o = _flash_core(q, k, v, causal)
    elif chunk_q and S > chunk_q and S % chunk_q == 0:
        o = chunked_gqa_attention(q, k, v, causal=causal, block_q=chunk_q)
    else:
        s = gqa_scores(q, k)                              # [B,Kh,G,S,S]
        if causal:
            keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
            s = masked_fill(s, ~keep, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        o = gqa_out(p, v)
    o = shard(o, ("batch", None, "heads", None))
    return matmul(fit_merge(o, 2).reshape(B, S, n_heads * head_dim),
                  params["wo"])


def cross_attention(params, x, kv_cache, *, n_heads, n_kv, head_dim):
    """x [B,Sq,D] attends to precomputed (k, v) [B,Skv,Kh,Dh] (whisper's
    decoder over the encoder's output): no mask, no rope, plain ops on
    every impl, as the reference computes it outside any kernel."""
    B, Sq, _ = x.shape
    q = fit_split(matmul(x, params["wq"]), -1, n_heads).reshape(
        B, Sq, n_heads, head_dim)
    if "bq" in params:
        q = q + params["bq"].reshape(n_heads, head_dim)
    k, v = kv_cache
    p = torch.softmax(gqa_scores(q, k), dim=-1)
    o = gqa_out(p, v)
    return matmul(fit_merge(o, 2).reshape(B, Sq, n_heads * head_dim),
                  params["wo"])


def cross_kv(params, enc_out, *, n_kv, head_dim):
    """The encoder output's keys and values [B,Skv,Kh,Dh] for
    ``cross_attention``."""
    B, Skv, _ = enc_out.shape
    k = fit_split(matmul(enc_out, params["wk"]), -1, n_kv).reshape(
        B, Skv, n_kv, head_dim)
    v = fit_split(matmul(enc_out, params["wv"]), -1, n_kv).reshape(
        B, Skv, n_kv, head_dim)
    if "bk" in params:
        k = k + params["bk"].reshape(n_kv, head_dim)
        v = v + params["bv"].reshape(n_kv, head_dim)
    return k, v


def decode_attention(params, x, k_cache, v_cache, pos, *, n_heads, n_kv,
                     head_dim, rope_theta=1e4, rope_fraction=1.0):
    """One-token decode. x [B,1,D]; caches [B,S,Kh,Dh]; pos an int.

    Writes the new k/v at ``pos`` into the caches in place (where JAX
    returns updated copies) and attends over positions <= pos. Returns
    (out [B,1,D], k_cache, v_cache)."""
    B = x.shape[0]
    S = k_cache.shape[1]
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"decode_attention: pos={pos} outside the cache's "
                         f"{S} positions")
    q, k, v = qkv(params, x, n_heads, n_kv, head_dim)
    posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posv, rope_theta, rope_fraction)
    k = apply_rope(k, posv, rope_theta, rope_fraction)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    s = gqa_scores(q, k_cache)                            # [B,Kh,G,1,S]
    s = masked_fill(s, torch.arange(S, device=x.device) > pos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = gqa_out(p, v_cache)
    out = matmul(fit_merge(o, 2).reshape(B, 1, n_heads * head_dim),
                 params["wo"])
    return out, k_cache, v_cache
