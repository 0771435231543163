"""Mamba-2 block with the SSD (state-space duality) chunked algorithm, the
PyTorch counterpart of ``repro.models.mamba``.

Sequence mixing costs O(S·Q) a head (Q the chunk): within a chunk the
recurrence is a dense [Q, Q] masked matmul, and chunks are chained through
the carried [B, H, P, N] state. Decode is one recurrence step on that
state. SSD runs as plain torch ops (the reference runs it as plain einsums,
outside any Pallas kernel), always in fp32.

``ssd_chunked`` computes everything that does not depend on the carried
state for all chunks at once (the cumulative decays, C·Bᵀ, the masked
decay matrix, the intra-chunk outputs, each chunk's own state update) and
loops only over the recurrence ``state = exp(total_c) · state + upd_c``,
one ``addcmul`` a chunk; the inter-chunk outputs then come from the
states entering each chunk, in one batched product. The values are the
reference's, in its order of operations up to the order of sums.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.common import (cumsum, dense_init, einsum,
                                       fit_merge, is_dtensor, matmul, randn,
                                       rms_norm, shard)


def dims(d_model: int, ssm: SSMConfig):
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    d_conv_in = d_inner + 2 * ssm.ngroups * ssm.d_state
    return d_inner, n_heads, d_conv_in


def init_mamba(gen, n_layers, d_model: int, ssm: SSMConfig,
               dtype=torch.float32):
    """The block's parameters for ``n_layers`` layers, stacked on a leading
    axis and drawn from the ``torch.Generator`` ``gen``: in/out projections
    (LeCun normal), the depthwise conv (normal · 0.1, zero bias), dt bias 0,
    A_log = log(linspace(1, 16, H)), D and the norm scale 1."""
    L = n_layers
    d_inner, H, d_xbc = dims(d_model, ssm)
    dev = gen.device
    conv_w = randn(gen, (L, ssm.d_conv, d_xbc))
    a_log = torch.linspace(1.0, 16.0, H, device=dev).log()
    full = lambda w, v: torch.full((L, w), v, dtype=dtype,  # noqa: E731
                                   device=dev)
    return {
        "in_proj": dense_init(gen, (L, d_model, 2 * d_inner
                                    + 2 * ssm.ngroups * ssm.d_state + H),
                              dtype),
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": full(d_xbc, 0.0),
        "dt_bias": full(H, 0.0),
        "A_log": a_log.repeat(L, 1).to(dtype),
        "D": full(H, 1.0),
        "norm": full(d_inner, 1.0),
        "out_proj": dense_init(gen, (L, d_inner, d_model), dtype),
    }


# ---------------------------------------------------------------------------
# SSD core


def ssd_reference(x, dt, A, B, C, *, dtype=torch.float32,
                  return_state=False):
    """Naive step-by-step recurrence oracle. x [b,S,H,P]; dt [b,S,H];
    A [H] (negative); B, C [b,S,H,N]. Returns y [b,S,H,P] in x's type
    (and, with ``return_state``, the final state [b,H,P,N]), computed in
    ``dtype`` (fp32 as the reference; float64 for a tighter oracle)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    out_dtype = x.dtype
    x, dt, B, C = (t.to(dtype) for t in (x, dt, B, C))
    A = A.to(dtype)
    h = x.new_zeros((b, H, P, N))
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)[..., None, None]     # [b,H,1,1]
        dbx = (x[:, t] * dt[:, t, :, None])[..., None] * B[:, t, :, None, :]
        h = decay * h + dbx
        ys.append((h @ C[:, t, :, :, None])[..., 0])          # [b,H,P]
    y = torch.stack(ys, dim=1).to(out_dtype)
    return (y, h) if return_state else y


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD. Same arguments as ``ssd_reference``; S must be a
    multiple of ``chunk`` (TypeError otherwise, as the reference's reshape
    raises). ``h0`` [b,H,P,N] is the state entering the sequence (zeros by
    default). Returns (y [b,S,H,P] in x's type, final state [b,H,P,N]
    fp32)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    if chunk <= 0 or S % chunk:
        raise TypeError(f"ssd_chunked: S={S} is not a multiple of "
                        f"chunk={chunk}")
    nc, Q = S // chunk, chunk
    f32 = torch.float32

    def rs(t):                        # [b,S,...] -> [b,nc,Q,...] fp32
        return t.to(f32).reshape(b, nc, Q, *t.shape[2:])

    xc, dtc, Bc, Cc = rs(x), rs(dt), rs(B), rs(C)
    a = dtc * A.to(f32)                                      # [b,nc,Q,H]
    cum = cumsum(a, 2)                                       # inclusive
    total = cum[:, :, -1]                                    # [b,nc,H]
    cum_t = cum.transpose(2, 3)                              # [b,nc,H,Q]
    # intra-chunk: the masked decay matrix, masked BEFORE the exp (t < s
    # entries have positive exponents)
    CB = einsum("bcqhn,bcshn->bchqs", Cc, Bc)          # [b,nc,H,Q,Q]
    L = cum_t[..., :, None] - cum_t[..., None, :]
    keep = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # the masked-exp chain in place when serving (two [b,nc,H,Q,Q] tensors
    # alive, not four); the same operations out of place under autograd
    track = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, A, B, C, h0))
    if track:
        L = torch.where(keep, L, -math.inf).exp()
        scores = CB * L * dtc.transpose(2, 3)[..., None, :]
    else:
        L.masked_fill_(~keep, -math.inf).exp_()
        scores = CB.mul_(L).mul_(dtc.transpose(2, 3)[..., None, :])
    del L
    y = einsum("bchqs,bcshp->bcqhp", scores, xc)
    del scores, CB
    # each chunk's own state update, and its decay over the whole chunk
    dec_out = torch.exp(total[:, :, None, :] - cum) * dtc    # [b,nc,Q,H]
    upd = einsum("bcshn,bcshp->bchpn", Bc,
                       xc * dec_out[..., None])              # [b,nc,H,P,N]
    decay = torch.exp(total)[..., None, None]                # [b,nc,H,1,1]
    # the recurrence: states[c] is the state entering chunk c
    st = [torch.zeros((b, H, P, N), dtype=f32, device=x.device)
          if h0 is None else h0.to(f32)]
    for c in range(nc):
        st.append(torch.addcmul(upd[:, c], st[c], decay[:, c]))
    states = torch.stack(st)
    # inter-chunk outputs from the carried states, all chunks at once
    y += einsum("bcqhn,bchpn->bcqhp",
                      Cc * torch.exp(cum)[..., None],
                      states[:nc].transpose(0, 1))
    return y.reshape(b, S, H, P).to(x.dtype), states[nc]


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """One decode step. state [b,H,P,N] fp32; x_t [b,H,P]; dt_t [b,H];
    B_t, C_t [b,H,N]. Returns (state, y [b,H,P] in x_t's type)."""
    f32 = torch.float32
    dt32 = dt_t.to(f32)
    decay = torch.exp(dt32 * A.to(f32))[..., None, None]
    dbx = (x_t.to(f32) * dt32[..., None])[..., None] \
        * B_t.to(f32)[..., None, :]
    state = decay * state + dbx
    if is_dtensor(state) or is_dtensor(C_t):
        # DTensor's batched-matmul strategy search is slow on a 3-d mesh
        y = einsum("bhpn,bhn->bhp", state, C_t.to(f32))
    else:
        y = (state @ C_t.to(f32)[..., None])[..., 0]
    return state, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# full block


def _split_proj(params, x, d_model, ssm: SSMConfig):
    d_inner, H, _ = dims(d_model, ssm)
    gn = ssm.ngroups * ssm.d_state
    proj = matmul(x, params["in_proj"])
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * gn]
    dt_raw = proj[..., 2 * d_inner + 2 * gn:]
    return z, xbc, dt_raw


def _split_xbc(xbc, d_inner, ssm: SSMConfig):
    gn = ssm.ngroups * ssm.d_state
    return (xbc[..., :d_inner], xbc[..., d_inner:d_inner + gn],
            xbc[..., d_inner + gn:])


def _bc_heads(t, b, S, H, ssm: SSMConfig):
    """[..., G*N] -> each group broadcast over its heads -> [b,S,H,N]."""
    G = ssm.ngroups
    t = t.reshape(b, S, G, ssm.d_state)
    return t.repeat_interleave(H // G, dim=2)


def _dt_a(params, dt_raw):
    """dt = softplus(dt_raw + dt_bias) and A = -exp(A_log), both fp32
    (torch's softplus, linear past 20, is within 2e-9 relative of
    ``jax.nn.softplus``)."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    return dt, -torch.exp(params["A_log"].float())


def mamba_block(params, x, d_model: int, ssm: SSMConfig):
    """Full-sequence mixing. x [B,S,D] -> [B,S,D]."""
    b, S, _ = x.shape
    d_inner, H, _ = dims(d_model, ssm)
    z, xbc, dt_raw = _split_proj(params, x, d_model, ssm)
    # causal depthwise conv, width d_conv: the sum of shifted slices over
    # the input after d_conv - 1 zero rows (a cat: DTensor's pad plan
    # fails on some meshes)
    front = torch.zeros_like(xbc[:, :1]).expand(b, ssm.d_conv - 1,
                                                xbc.shape[-1])
    pad = torch.cat([front, xbc], dim=1)
    conv = sum(pad[:, i:i + S] * params["conv_w"][i]
               for i in range(ssm.d_conv)) + params["conv_b"]
    x_ssm, B, C = _split_xbc(F.silu(conv), d_inner, ssm)
    x_h = x_ssm.reshape(b, S, H, ssm.head_dim)
    x_h = shard(x_h, ("batch", None, "heads", None))
    dt, A = _dt_a(params, dt_raw)
    # B and C broadcast over the heads take x_h's head shards, where
    # GSPMD's propagation puts them (DTensor propagates nothing)
    Bh, Ch = (shard(_bc_heads(t, b, S, H, ssm),
                    ("batch", None, "heads", None)) for t in (B, C))
    y, _ = ssd_chunked(x_h, dt, A, Bh, Ch, min(ssm.chunk_size, S))
    y = y + x_h * params["D"][None, None, :, None]
    y = rms_norm(fit_merge(y, 2).reshape(b, S, d_inner) * F.silu(z),
                 params["norm"])
    return matmul(y, params["out_proj"])


def init_mamba_cache(d_model: int, ssm: SSMConfig, batch: int,
                     dtype=torch.float32):
    """One layer's decode state: the conv window's last d_conv - 1 inputs
    (in ``dtype``) and the SSM state (fp32). The model's cache
    (``transformer.init_cache``) holds these stacked over its layers."""
    _, H, d_xbc = dims(d_model, ssm)
    return {"conv": torch.zeros((batch, ssm.d_conv - 1, d_xbc), dtype=dtype),
            "ssm": torch.zeros((batch, H, ssm.head_dim, ssm.d_state),
                               dtype=torch.float32)}


def mamba_decode(params, x, cache, d_model: int, ssm: SSMConfig):
    """One-token step. x [B,1,D] -> ([B,1,D], new cache). The conv window
    runs in fp32 (the reference promotes the fp32 cache against the
    compute-type input and weights; torch wants the casts spelled out) and
    its output returns to the compute type."""
    b = x.shape[0]
    d_inner, H, _ = dims(d_model, ssm)
    z, xbc, dt_raw = _split_proj(params, x[:, 0], d_model, ssm)
    f32 = torch.float32
    window = torch.cat([cache["conv"].to(f32), xbc[:, None, :].to(f32)],
                       dim=1)
    conv = einsum("bkc,kc->bc", window, params["conv_w"].to(f32)) \
        + params["conv_b"].to(f32)
    x_ssm, B, C = _split_xbc(F.silu(conv).to(x.dtype), d_inner, ssm)
    x_h = x_ssm.reshape(b, H, ssm.head_dim)
    dt, A = _dt_a(params, dt_raw)
    state, y = ssd_step(cache["ssm"], x_h, dt, A,
                        _bc_heads(B, b, 1, H, ssm)[:, 0],
                        _bc_heads(C, b, 1, H, ssm)[:, 0])
    y = y + x_h * params["D"][None, :, None]
    y = rms_norm(y.reshape(b, d_inner) * F.silu(z), params["norm"])
    out = matmul(y, params["out_proj"])[:, None, :]
    return out, {"conv": window[:, 1:], "ssm": state}
