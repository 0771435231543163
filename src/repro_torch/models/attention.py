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
from repro_torch.models.common import dense_init, matmul
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
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    return q, k, v


def gqa_scores(q, k):
    """q [B,Sq,H,Dh], k [B,Sk,Kh,Dh] -> fp32 scores [B,Kh,G,Sq,Sk]
    (products of the inputs' values, summed in fp32)."""
    B, Sq, H, Dh = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, Sq, Kh, H // Kh, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    return s.div_(math.sqrt(Dh))


def gqa_out(probs, v):
    """probs [B,Kh,G,Sq,Sk], v [B,Sk,Kh,Dh] -> [B,Sq,H,Dh] in v's type
    (the probabilities are cast to v's type first, as in JAX)."""
    B, Kh, G, Sq, _ = probs.shape
    Dh = v.shape[-1]
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return o.reshape(B, Sq, Kh * G, Dh)


def chunked_gqa_attention(q, k, v, *, causal=True, block_q=1024):
    """Online attention in plain PyTorch: queries in blocks of
    ``block_q``, each seeing one [..., Bq, S] score tile.

    q [B,S,H,Dh]; k/v [B,S,Kh,Dh]. Returns [B,S,H,Dh]."""
    B, S, H, Dh = q.shape
    Kh = k.shape[2]
    G = H // Kh
    bq = min(block_q, S)
    if S % bq:
        raise ValueError(f"chunked_gqa_attention: S={S} is not a multiple "
                         f"of block_q={bq}")
    qg = q.reshape(B, S, Kh, G, Dh).permute(0, 2, 3, 1, 4)   # [B,Kh,G,S,D]
    kt = k.permute(0, 2, 1, 3)                               # [B,Kh,S,D]
    vt = v.permute(0, 2, 1, 3)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))  # as JAX
    cols = torch.arange(S, device=q.device)
    blocks = []
    for i in range(S // bq):
        qb = qg[:, :, :, i * bq:(i + 1) * bq]
        s = torch.einsum("bkgqd,bksd->bkgqs", qb.float(), kt.float())
        s.mul_(scale)
        if causal:
            rows = i * bq + torch.arange(bq, device=q.device)
            s.masked_fill_(~(rows[:, None] >= cols[None, :]), NEG_INF)
        p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
        num = torch.einsum("bkgqs,bksd->bkgqd", p.to(vt.dtype), vt)
        den = p.sum(dim=-1, keepdim=True).to(vt.dtype)
        blocks.append(num / den.clamp_min(1e-20))
    o = torch.cat(blocks, dim=3)                             # [B,Kh,G,S,D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh)


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
    if impl == "cuda":
        o = _flash_core(q, k, v, causal)
    elif chunk_q and S > chunk_q and S % chunk_q == 0:
        o = chunked_gqa_attention(q, k, v, causal=causal, block_q=chunk_q)
    else:
        s = gqa_scores(q, k)                              # [B,Kh,G,S,S]
        if causal:
            keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
            s.masked_fill_(~keep, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        o = gqa_out(p, v)
    return matmul(o.reshape(B, S, n_heads * head_dim), params["wo"])


def cross_attention(params, x, kv_cache, *, n_heads, n_kv, head_dim):
    """x [B,Sq,D] attends to precomputed (k, v) [B,Skv,Kh,Dh] (whisper's
    decoder over the encoder's output): no mask, no rope, plain ops on
    every impl, as the reference computes it outside any kernel."""
    B, Sq, _ = x.shape
    q = matmul(x, params["wq"]).reshape(B, Sq, n_heads, head_dim)
    if "bq" in params:
        q = q + params["bq"].reshape(n_heads, head_dim)
    k, v = kv_cache
    p = torch.softmax(gqa_scores(q, k), dim=-1)
    o = gqa_out(p, v)
    return matmul(o.reshape(B, Sq, n_heads * head_dim), params["wo"])


def cross_kv(params, enc_out, *, n_kv, head_dim):
    """The encoder output's keys and values [B,Skv,Kh,Dh] for
    ``cross_attention``."""
    B, Skv, _ = enc_out.shape
    k = matmul(enc_out, params["wk"]).reshape(B, Skv, n_kv, head_dim)
    v = matmul(enc_out, params["wv"]).reshape(B, Skv, n_kv, head_dim)
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
    s.masked_fill_(torch.arange(S, device=x.device) > pos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = gqa_out(p, v_cache)
    out = matmul(o.reshape(B, 1, n_heads * head_dim), params["wo"])
    return out, k_cache, v_cache
