"""Model assembly for the dense decoder-only family, serving side (the
PyTorch counterpart of the dense branch of ``repro.models.transformer``).

  init_params(cfg, seed, device)               -> params (nested dicts)
  prefill(cfg, params, batch, impl)            -> logits [B,S,V] (fp32)
  init_cache(cfg, batch, max_seq, device)      -> decode cache
  decode_step(cfg, params, cache, token, pos)  -> (logits [B,1,V], cache)
  params_from_jax(tree, device)                -> the reference's params

Layer parameters are stacked on a leading axis of length n_layers, as in
the reference (which scans over them); here a Python loop takes layer l's
slice and casts it to the compute type inside the loop, so no copy of the
whole model in the compute type is ever held. Entry points run on the card
unless the caller passes ``device="cpu"``. The other families (MoE, MLA,
SSM, hybrid, audio, VLM) raise NotImplementedError naming their ROADMAP
item.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import resolve
from repro_torch.models.attention import (decode_attention, full_attention,
                                          init_attn)
from repro_torch.models.common import (cast_tree, dense_init, embed_init,
                                       rms_norm)
from repro_torch.models.mlp import init_mlp, mlp

CACHE_DTYPE = torch.bfloat16
# ROADMAP.md queue 1, item 14: the LM families not ported yet
UNPORTED = {"moe": "14.1 (MoE) and 14.2 (MLA)", "ssm": "14.3 (SSM/Mamba)",
            "hybrid": "14.4 (hybrid, Jamba)", "audio": "14.5 (audio)",
            "vlm": "14.6 (VLM)"}


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype.param_dtype)


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype.compute_dtype)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or any(
            (cfg.moe, cfg.mla, cfg.ssm, cfg.encoder, cfg.vision,
             cfg.hybrid_attn_period, cfg.mtp)):
        item = UNPORTED.get(cfg.family, "14")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet (ROADMAP.md queue 1, item {item}); only the "
            f"dense family is")


# ---------------------------------------------------------------------------
# parameters


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random parameters in the reference's tree layout, drawn by a
    ``torch.Generator`` seeded with ``seed`` on ``device`` itself (billions
    of normals are quick there and slow on the host); the numbers differ
    from JAX's (tests carry JAX's across with ``params_from_jax``)."""
    _require_dense(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = _pdt(cfg)
    D, L = cfg.d_model, cfg.n_layers
    p = {"embed": embed_init(gen, (cfg.vocab_size, D), dt),
         "final_norm": torch.ones((D,), dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (D, cfg.vocab_size), dtype=dt)
    p["blocks"] = {
        "ln1": torch.ones((L, D), dtype=dt, device=dev),
        "mixer": init_attn(gen, L, D, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, cfg.qkv_bias, dt),
        "ln2": torch.ones((L, D), dtype=dt, device=dev),
        "ffn": init_mlp(gen, L, D, cfg.d_ff, cfg.act, dt),
    }
    return p


def params_from_jax(tree, device="cuda"):
    """The reference's ``init_params`` tree, given as numpy arrays (or
    anything ``np.asarray`` reads), as this package's tree on ``device``.
    Each leaf keeps its type and shape (the stacked layer axis too); a
    bfloat16 leaf, which arrives as an ``ml_dtypes`` array torch cannot
    read, goes through float32 (exact) to ``torch.bfloat16``."""
    dev = resolve(device)

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32), device=dev).to(
                torch.bfloat16)
        return torch.tensor(a, device=dev)

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(v) for k, v in t.items()}
        return leaf(t)
    return walk(tree)


def _layer(stack, l: int):
    """Layer ``l``'s slice of a stacked parameter tree (views)."""
    if isinstance(stack, Mapping):
        return {k: _layer(v, l) for k, v in stack.items()}
    return stack[l]


# ---------------------------------------------------------------------------
# forward


def _block(cfg: ModelConfig, bp, h, impl: str):
    bp = cast_tree(bp, _cdt(cfg))
    x = rms_norm(h, bp["ln1"], cfg.norm_eps)
    h = h + full_attention(bp["mixer"], x, n_heads=cfg.n_heads,
                           n_kv=cfg.n_kv_heads,
                           head_dim=cfg.resolved_head_dim,
                           rope_theta=cfg.rope_theta,
                           rope_fraction=cfg.rope_fraction, causal=True,
                           chunk_q=cfg.attn_chunk_q, impl=impl)
    x = rms_norm(h, bp["ln2"], cfg.norm_eps)
    return h + mlp(bp["ffn"], x, cfg.act)


def _embed_tokens(cfg: ModelConfig, params, tokens):
    emb = params["embed"]
    idx = torch.as_tensor(tokens, device=emb.device).long()
    return emb[idx].to(_cdt(cfg))


def _unembed(cfg: ModelConfig, params, h):
    """fp32 logits of the final norm's output ``h`` against the LM head
    cast to the compute type. The reference's einsum (with
    ``preferred_element_type=float32``) promotes both to fp32: ``h`` is
    fp32 there (bf16 values times the fp32 ``final_norm`` scale) and is
    not rounded. On the CPU that is an fp32 product of the two. On the
    card the head stays bf16 for the tensor cores and ``h`` is split into
    bf16 parts, hi = h rounded and lo = (h - hi) rounded (hi + lo is
    within 2^-17 of h); each is multiplied by ``torch.mm(...,
    out_dtype=float32)`` (fp32 sums) and the two are added. A bf16
    ``torch.matmul`` would round the logits to bf16, and rounding ``h``
    alone would move it by up to 2^-9."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    cdt = _cdt(cfg)
    B, S, D = h.shape
    a, b = h.reshape(B * S, D), w.to(cdt)
    if cdt == torch.float32 or not a.is_cuda:
        logits = a.float() @ b.float()
    else:
        hi = a.to(cdt)
        logits = torch.mm(hi, b, out_dtype=torch.float32)
        if a.dtype != cdt:
            lo = (a.float() - hi.float()).to(cdt)
            logits += torch.mm(lo, b, out_dtype=torch.float32)
    return logits.reshape(B, S, -1)


def backbone(cfg: ModelConfig, params, batch, impl: str = "cuda"):
    """Token embeddings -> final hidden states [B,S,D]. ``batch`` is a dict
    with 'tokens' [B,S]. (The reference also returns the MoE balance loss,
    which the dense family does not have.)"""
    _require_dense(cfg)
    h = _embed_tokens(cfg, params, batch["tokens"])
    for l in range(cfg.n_layers):
        h = _block(cfg, _layer(params["blocks"], l), h, impl)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def prefill(cfg: ModelConfig, params, batch, impl: str = "cuda"):
    """Full-sequence forward producing fp32 logits [B,S,V]. ``impl="cuda"``
    runs every layer's attention core through ``flash_attention``;
    ``impl="torch"`` through the reference's plain path."""
    return _unembed(cfg, params, backbone(cfg, params, batch, impl))


# ---------------------------------------------------------------------------
# decode: cache init + one-token step


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zeroed decode cache: {"attn": {"k", "v"}}, each
    [n_layers, batch, max_seq, n_kv_heads, head_dim] in bfloat16 (the
    reference's CACHE_DTYPE, whatever the compute type)."""
    _require_dense(cfg)
    dev = resolve(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"attn": {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=dev),
                     "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=dev)}}


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token [B,1] ints; pos an int. Returns (logits [B,1,V], cache), the
    cache updated in place at ``pos`` (the reference returns a copy)."""
    _require_dense(cfg)
    h = _embed_tokens(cfg, params, token)
    ks, vs = cache["attn"]["k"], cache["attn"]["v"]
    for l in range(cfg.n_layers):
        bp = cast_tree(_layer(params["blocks"], l), _cdt(cfg))
        x = rms_norm(h, bp["ln1"], cfg.norm_eps)
        out, _, _ = decode_attention(
            bp["mixer"], x, ks[l], vs[l], pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction)
        h = h + out
        x = rms_norm(h, bp["ln2"], cfg.norm_eps)
        h = h + mlp(bp["ffn"], x, cfg.act)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h), cache
