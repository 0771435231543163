"""Multi-head Latent Attention (DeepSeek V2/V3), the PyTorch counterpart
of ``repro.models.mla``.

KV is compressed into a rank-``r`` latent ``c_kv`` plus one rotary key
``k_rope`` shared by the heads; decode caches only those two. Decode uses
the absorbed form (W_uk folded into the query, W_uv into the output), in
plain ops on both impls as the reference. Prefill materializes per-head K
and V.

``impl`` selects prefill's attention core. ``"torch"`` keeps both of the
reference's plain branches: the full [S, S] softmax, and the online one
over query blocks of ``chunk_q``. ``"cuda"`` runs it through
``kernels.flash_attention``: q = [q_nope | roped q_rope] and k = [k_nope |
roped k_rope, the same for every head], each nope + rope wide, so the
kernel's 1/sqrt(D) is the reference's 1/sqrt(nope + rope); v goes at its
own width (``v_head_dim``, at most nope + rope), as in the reference's
einsum, and the output comes back that wide (deepseek's (192, 128) runs
on the wgmma kernel). Where the reference asks for fp32 results
(``preferred_element_type``), the operands are upcast first: products of
bf16 values are exact in fp32.
"""
from __future__ import annotations


import numpy as np
import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (dense_init, einsum, fit_merge,
                                       fit_split, masked_fill, matmul,
                                       rms_norm, shard)
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
IMPLS = ("cuda", "torch")


def init_mla(gen, n_layers, d_model, n_heads, mla: MLAConfig,
             dtype=torch.float32):
    """MLA's projections of ``n_layers`` layers, stacked on a leading
    axis (fan-in: each matrix's input width)."""
    L, r = n_layers, mla.kv_lora_rank
    qk_dim = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    dev = gen.device
    p = {"w_dkv": dense_init(gen, (L, d_model, r), dtype),
         "w_kr": dense_init(gen, (L, d_model, mla.qk_rope_head_dim), dtype),
         "w_uk": dense_init(gen, (L, r, n_heads * mla.qk_nope_head_dim),
                            dtype),
         "w_uv": dense_init(gen, (L, r, n_heads * mla.v_head_dim), dtype),
         "wo": dense_init(gen, (L, n_heads * mla.v_head_dim, d_model), dtype),
         "kv_norm": torch.ones((L, r), dtype=dtype, device=dev)}
    if mla.q_lora_rank:
        p["w_dq"] = dense_init(gen, (L, d_model, mla.q_lora_rank), dtype)
        p["w_uq"] = dense_init(gen, (L, mla.q_lora_rank, n_heads * qk_dim),
                               dtype)
        p["q_norm"] = torch.ones((L, mla.q_lora_rank), dtype=dtype,
                                 device=dev)
    else:
        p["wq"] = dense_init(gen, (L, d_model, n_heads * qk_dim), dtype)
    return p


def _queries(params, x, n_heads, mla: MLAConfig):
    B, S, _ = x.shape
    qk_dim = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    if "w_dq" in params:
        q = matmul(rms_norm(matmul(x, params["w_dq"]), params["q_norm"]),
                   params["w_uq"])
    else:
        q = matmul(x, params["wq"])
    q = fit_split(q, -1, n_heads).reshape(B, S, n_heads, qk_dim)
    return q[..., :mla.qk_nope_head_dim], q[..., mla.qk_nope_head_dim:]


def _einsum(eq, a, b):
    """``einsum`` after promoting both operands to their common type
    (as jnp does)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return einsum(eq, a.to(dt), b.to(dt))


def _scale(mla: MLAConfig) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(
        mla.qk_nope_head_dim + mla.qk_rope_head_dim)))


def _flash_core(q_nope, q_rope, k_nope, k_rope, v, causal):
    """[B,S,H,*] operands through ``flash_attention``: q and k nope + rope
    wide, v at its own width, heads to the front; returns [B,S,H,vd]."""
    B, S, H, vd = v.shape
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, k_rope.shape[-1])],
                  dim=-1)
    D = q.shape[-1]
    if vd > D:
        raise ValueError(f"mla_full: v_head_dim={vd} is wider than "
                         f"nope + rope = {D}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return flash_attention(qt, kt, vt, causal=causal).transpose(1, 2)


def mla_full(params, x, *, n_heads, mla: MLAConfig, rope_theta=1e4,
             causal=True, positions=None, chunk_q: int = 0,
             impl: str = "cuda"):
    """Train / prefill path. Returns (out [B,S,D], (c_kv [B,S,r],
    k_rope [B,S,rd])).

    ``impl="cuda"`` runs the core through ``flash_attention`` whatever
    ``chunk_q`` says; ``impl="torch"`` the full [S, S] softmax, or the
    online softmax over query blocks when ``chunk_q`` > 0 divides S into
    several."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}, expected one of {IMPLS}")
    B, S, _ = x.shape
    nope, vd = mla.qk_nope_head_dim, mla.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _queries(params, x, n_heads, mla)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv = rms_norm(matmul(x, params["w_dkv"]), params["kv_norm"])  # [B,S,r]
    k_rope = apply_rope(matmul(x, params["w_kr"])[:, :, None, :],
                        positions, rope_theta)                 # [B,S,1,rd]
    k_nope = fit_split(matmul(c_kv, params["w_uk"]), -1, n_heads).reshape(
        B, S, n_heads, nope)
    v = fit_split(matmul(c_kv, params["w_uv"]), -1, n_heads).reshape(
        B, S, n_heads, vd)
    q_nope = shard(q_nope, ("batch", None, "heads", None))
    k_nope = shard(k_nope, ("batch", None, "heads", None))
    scale = _scale(mla)

    if impl == "cuda":
        o = _flash_core(q_nope, q_rope, k_nope, k_rope, v, causal)
    elif chunk_q and S > chunk_q and S % chunk_q == 0:
        bq = chunk_q
        kr = k_rope[:, :, 0, :].float()
        kn = k_nope.float()
        cols = torch.arange(S, device=x.device)
        blocks = []
        for i in range(S // bq):
            qs = q_nope[:, i * bq:(i + 1) * bq].float()
            qr = q_rope[:, i * bq:(i + 1) * bq].float()
            sb = einsum("bqhd,bshd->bhqs", qs, kn)
            sb += einsum("bqhd,bsd->bhqs", qr, kr)
            sb.mul_(scale)
            if causal:
                rows = i * bq + torch.arange(bq, device=x.device)
                sb = masked_fill(sb, ~(rows[:, None] >= cols[None, :]),
                                 NEG_INF)
            pb = sb.sub_(sb.amax(dim=-1, keepdim=True)).exp_()
            num = _einsum("bhqs,bshd->bqhd", pb.to(v.dtype), v)
            den = pb.sum(dim=-1).to(v.dtype)                  # [B,h,q]
            blocks.append(num / den.transpose(1, 2)[..., None].clamp_min(
                1e-20))
        o = torch.cat(blocks, dim=1)
    else:
        s = einsum("bqhd,bshd->bhqs", q_nope.float(), k_nope.float())
        s += einsum("bqhd,bsxd->bhqs", q_rope.float(), k_rope.float())
        s.mul_(scale)
        if causal:
            keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
            s = masked_fill(s, ~keep, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        o = _einsum("bhqs,bshd->bqhd", p.to(v.dtype), v)
    o = shard(o, ("batch", None, "heads", None))
    out = matmul(fit_merge(o, 2).reshape(B, S, n_heads * vd), params["wo"])
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, ckv_cache, krope_cache, pos, *, n_heads,
               mla: MLAConfig, rope_theta=1e4):
    """Absorbed one-token decode. x [B,1,D]; ckv_cache [B,S,r];
    krope_cache [B,S,rd]; pos an int. Writes the new latent and rotary key
    at ``pos`` into the caches in place (the reference returns updated
    copies) and attends over positions <= pos. Returns (out [B,1,D],
    ckv_cache, krope_cache)."""
    B = x.shape[0]
    S = ckv_cache.shape[1]
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"mla_decode: pos={pos} outside the cache's {S} "
                         f"positions")
    nope, vd, r = mla.qk_nope_head_dim, mla.v_head_dim, mla.kv_lora_rank
    posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _queries(params, x, n_heads, mla)
    q_rope = apply_rope(q_rope, posv, rope_theta)              # [B,1,H,rd]
    c_kv = rms_norm(matmul(x, params["w_dkv"]), params["kv_norm"])
    k_rope = apply_rope(matmul(x, params["w_kr"])[:, :, None, :], posv,
                        rope_theta)[:, :, 0, :]                # [B,1,rd]
    ckv_cache[:, pos] = c_kv[:, 0].to(ckv_cache.dtype)
    krope_cache[:, pos] = k_rope[:, 0].to(krope_cache.dtype)
    # absorb W_uk into q: q_lat [B,1,H,r]
    w_uk = fit_split(params["w_uk"], -1, n_heads).reshape(r, n_heads, nope)
    q_lat = _einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    s = einsum("bqhr,bsr->bhqs", q_lat.float(), ckv_cache.float())
    s += einsum("bqhd,bsd->bhqs", q_rope.float(), krope_cache.float())
    s.mul_(_scale(mla))
    s = masked_fill(s, torch.arange(S, device=x.device) > pos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = einsum("bhqs,bsr->bqhr", p.to(ckv_cache.dtype), ckv_cache)
    w_uv = fit_split(params["w_uv"], -1, n_heads).reshape(r, n_heads, vd)
    o = _einsum("bqhr,rhd->bqhd", ctx, w_uv)
    out = matmul(fit_merge(o, 2).reshape(B, 1, n_heads * vd), params["wo"])
    return out, ckv_cache, krope_cache
