"""Model assembly for every family of the registry, the PyTorch
counterpart of ``repro.models.transformer``: the dense decoder-only
family, the MoE family (MLA attention with MoE FFNs: deepseek-v2-lite-16b,
deepseek-v3-671b), the SSM family (Mamba-2 blocks with no FFN:
mamba2-2.7b), the hybrid family (Jamba: periods of Mamba-2 layers around
one attention layer, a MoE FFN on every other layer), the audio family
(whisper-tiny: an encoder over precomputed frame embeddings, a decoder
with self- and cross-attention, layer norms with biases, learned
positions, the GELU MLP) and the VLM family (pixtral-12b: the dense family
with precomputed patch embeddings spliced over the first token
embeddings).

  init_params(cfg, seed, device, max_seq)      -> params (nested dicts)
  backbone(cfg, params, batch, impl, remat)    -> (hidden [B,S,D], aux)
  train_logits(cfg, params, batch, remat)      -> (logits, extras)
  prefill(cfg, params, batch, impl)            -> logits [B,S,V] (fp32)
  init_cache(cfg, batch, max_seq, device)      -> decode cache
  decode_step(cfg, params, cache, token, pos)  -> (logits [B,1,V], cache)
  params_from_jax(tree, device)                -> the reference's params

Layer parameters are stacked on a leading axis, one stack a homogeneous
segment as in the reference (which scans over each): ``blocks``, and for
the ``dense_first_k`` layout ``dense_blocks`` before it; whisper's encoder
is ``enc_blocks``. The hybrid family's ``blocks`` is one period unrolled,
``{"l0": ..., "l7": ...}``, each layer stacked over the periods. Here a
Python loop takes layer l's slice and casts it to the compute type inside
the loop, so no copy of a whole stack in the compute type is ever held
(one MoE layer of deepseek-v2-lite has 585 M parameters); for fp32
parameters that cast rounds every leaf, the Mamba block's A_log, dt_bias,
D, conv and norm too, as the reference's ``_cast_block`` does.

``remat=True`` (training) runs each layer under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its
activations are recomputed in the backward, as the reference's
``jax.checkpoint`` around its scan body (whisper's encoder is not
rematerialized there either). deepseek-v3's multi-token-prediction
subtree (``mtp``) runs in ``train_logits`` only. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import resolve
from repro_torch.models.attention import (cross_attention, cross_kv,
                                          decode_attention, full_attention,
                                          init_attn)
from repro_torch.models.common import (MetaGenerator, cast_tree,
                                       dense_init, embed_init, is_dtensor,
                                       layer_norm, matmul, mm,
                                       replicate_dims, rms_norm, roll_left,
                                       shard)
from repro_torch.models.mamba import (dims as mamba_dims, init_mamba,
                                      mamba_block, mamba_decode)
from repro_torch.models.mla import init_mla, mla_decode, mla_full
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe_apply

CACHE_DTYPE = torch.bfloat16


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype.param_dtype)


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype.compute_dtype)


# ---------------------------------------------------------------------------
# layer kinds


def _is_moe_layer(cfg: ModelConfig, idx: int) -> bool:
    """Whether layer ``idx`` has a MoE FFN under the config's layout (the
    reference's rule; the layer stacks below follow it for
    ``dense_first_k``, and the hybrid family per layer of a period)."""
    if cfg.moe is None:
        return False
    m = cfg.moe
    if m.layout == "every":
        return True
    if m.layout == "alternate":
        return idx % 2 == 1
    if m.layout == "dense_first_k":
        return idx >= m.dense_first_k
    raise ValueError(m.layout)


def _jamba_is_attn(cfg: ModelConfig, idx: int) -> bool:
    """One attention layer a period, in its middle (index 4 of 8)."""
    return idx % cfg.hybrid_attn_period == cfg.hybrid_attn_period // 2


def _period(cfg: ModelConfig):
    """(mixer, FFN kind) of each layer of a hybrid period: attention or
    mamba, and a MoE FFN where ``_is_moe_layer`` says, else SwiGLU."""
    return [("attn" if _jamba_is_attn(cfg, i) else "mamba",
             "moe" if _is_moe_layer(cfg, i) else "dense")
            for i in range(cfg.hybrid_attn_period)]


def _stacks(cfg: ModelConfig):
    """(params key, cache key, layers, mixer, FFN kind or None) of each
    homogeneous layer stack, in the order they run (the reference's
    segments; the hybrid family's periods are ``_layers``')."""
    if cfg.family == "ssm":          # pure mamba: no FFN
        return [("blocks", "mamba", cfg.n_layers, "mamba", None)]
    cache_key = "moe" if cfg.mla is not None else "attn"
    if cfg.moe is not None and cfg.moe.dense_first_k:
        k = sum(not _is_moe_layer(cfg, i) for i in range(cfg.n_layers))
        return [("dense_blocks", "dense", k, "attn", "dense"),
                ("blocks", cache_key, cfg.n_layers - k, "attn", "moe")]
    return [("blocks", cache_key, cfg.n_layers, "attn",
             "moe" if cfg.moe is not None else "dense")]


def _layers(cfg: ModelConfig, params, cache=None):
    """(layer params, mixer, FFN kind, the layer's cache views or None) of
    every layer in the order it runs. A hybrid period's attention layer
    reads the period's KV cache, its mamba layers the period's conv and
    ssm state in order."""
    if cfg.hybrid_attn_period:
        kinds = _period(cfg)
        for j in range(cfg.n_layers // cfg.hybrid_attn_period):
            m = 0
            for i, (mixer, ffn) in enumerate(kinds):
                c = None
                if cache is not None and mixer == "attn":
                    c = {k: v[j] for k, v in cache["attn"].items()}
                elif cache is not None:
                    c = {k: cache[k][j, m] for k in ("conv", "ssm")}
                    m += 1
                yield _layer(params["blocks"][f"l{i}"], j), mixer, ffn, c
        return
    for key, ckey, n, mixer, ffn in _stacks(cfg):
        for l in range(n):
            c = None if cache is None else {
                k: v[l] for k, v in cache[ckey].items()}
            yield _layer(params[key], l), mixer, ffn, c


# ---------------------------------------------------------------------------
# parameters


def _init_block(cfg: ModelConfig, gen, n: int, mixer: str, ffn,
                cross: bool = False):
    """``n`` layers of one kind, stacked: norms (layer norms with biases
    for the audio family), the mixer (``"mamba"``, or ``"attn"``: MLA where
    the config has it, else grouped-query attention), whisper's decoder
    cross-attention and its norm where ``cross``, and the FFN (``"moe"``,
    ``"dense"``: SwiGLU, or the plain MLP for ``act="gelu"``; or None: no
    FFN and no second norm)."""
    dt, D = _pdt(cfg), cfg.d_model
    ones = lambda: torch.ones((n, D), dtype=dt, device=gen.device)  # noqa
    zeros = lambda: torch.zeros((n, D), dtype=dt, device=gen.device)  # noqa
    audio = cfg.family == "audio"
    p = {"ln1": ones()}
    if audio:
        p["ln1_b"] = zeros()
    if mixer == "mamba":
        p["mixer"] = init_mamba(gen, n, D, cfg.ssm, dt)
    elif cfg.mla is not None:
        p["mixer"] = init_mla(gen, n, D, cfg.n_heads, cfg.mla, dt)
    else:
        p["mixer"] = init_attn(gen, n, D, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.qkv_bias, dt)
    if ffn is None:
        return p
    p["ln2"] = ones()
    if audio:
        p["ln2_b"] = zeros()
    if cross:
        p["cross"] = init_attn(gen, n, D, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.qkv_bias, dt)
        p["ln3"], p["ln3_b"] = ones(), zeros()
    p["ffn"] = (init_moe(gen, n, D, cfg.moe, dt) if ffn == "moe"
                else init_mlp(gen, n, D, cfg.d_ff, cfg.act, dt))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                max_seq: int = 4096):
    """Random parameters in the reference's tree layout, drawn by a
    ``torch.Generator`` seeded with ``seed`` on ``device`` itself (billions
    of normals are quick there and slow on the host); the numbers differ
    from JAX's (tests carry JAX's across with ``params_from_jax``).
    ``max_seq`` sizes the audio family's learned positions ``pos_emb``.
    On ``device="meta"`` the tree has the same shapes and types and holds
    no memory (the counterpart of ``jax.eval_shape`` of the reference's
    ``init_params``)."""
    dev = resolve(device, allow_meta=True)
    gen = (MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    dt, D = _pdt(cfg), cfg.d_model
    vec = lambda fill: torch.full((D,), fill, dtype=dt,  # noqa: E731
                                  device=dev)
    p = {"embed": embed_init(gen, (cfg.vocab_size, D), dt),
         "final_norm": vec(1.0)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (D, cfg.vocab_size), dtype=dt)
    if cfg.family == "audio":        # whisper: encoder + decoder stacks
        p["final_norm_b"] = vec(0.0)
        p["pos_emb"] = embed_init(gen, (max_seq, D), dt)
        p["enc_pos_emb"] = embed_init(gen, (cfg.encoder.n_frames, D), dt)
        p["enc_blocks"] = _init_block(cfg, gen, cfg.encoder.n_layers,
                                      "attn", "dense")
        p["enc_norm"], p["enc_norm_b"] = vec(1.0), vec(0.0)
        p["blocks"] = _init_block(cfg, gen, cfg.n_layers, "attn", "dense",
                                  cross=True)
        return p
    if cfg.hybrid_attn_period:       # jamba: one period, unrolled
        n_per = cfg.n_layers // cfg.hybrid_attn_period
        p["blocks"] = {f"l{i}": _init_block(cfg, gen, n_per, mixer, ffn)
                       for i, (mixer, ffn) in enumerate(_period(cfg))}
        return p
    for key, _, n, mixer, ffn in _stacks(cfg):
        p[key] = _init_block(cfg, gen, n, mixer, ffn)
    if cfg.mtp:                      # deepseek-v3 multi-token prediction
        p["mtp"] = {"proj": dense_init(gen, (2 * D, D), dtype=dt),
                    "block": _layer(_init_block(cfg, gen, 1, "attn",
                                                "dense"), 0),
                    "norm_h": vec(1.0), "norm_e": vec(1.0)}
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


def _norm_in(cfg: ModelConfig, bp, h, name: str):
    """The norm before a sublayer: a layer norm with bias (``name + "_b"``)
    for the audio family, else an RMS norm."""
    if cfg.family == "audio":
        return layer_norm(h, bp[name], bp[name + "_b"], cfg.norm_eps)
    return rms_norm(h, bp[name], cfg.norm_eps)


def _run(remat: bool, fn, *args):
    """``fn(*args)``, under ``checkpoint`` where ``remat`` asks for it and
    autograd records (its activations are then recomputed in the
    backward instead of kept)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _ffn(cfg: ModelConfig, bp, h, kind: str):
    """The FFN half of a block: (h + FFN(norm(h)), the MoE balance loss or
    0)."""
    x = _norm_in(cfg, bp, h, "ln2")
    if kind == "moe":
        out, aux = moe_apply(bp["ffn"], x, cfg.moe, act=cfg.act)
        return h + out, aux
    return h + mlp(bp["ffn"], x, cfg.act), 0.0


def _block(cfg: ModelConfig, bp, h, mixer: str, ffn, impl: str,
           causal: bool = True):
    """One layer over the full sequence: (h', the MoE balance loss or 0).
    The Mamba mixer runs its SSD as plain ops on both impls; whisper's
    encoder layers are the ``causal=False`` ones."""
    h = shard(h, ("batch", None, None))
    bp = cast_tree(bp, _cdt(cfg))
    x = _norm_in(cfg, bp, h, "ln1")
    if mixer == "mamba":
        out = mamba_block(bp["mixer"], x, cfg.d_model, cfg.ssm)
    elif cfg.mla is not None:
        out, _ = mla_full(bp["mixer"], x, n_heads=cfg.n_heads, mla=cfg.mla,
                          rope_theta=cfg.rope_theta, causal=causal,
                          chunk_q=cfg.attn_chunk_q, impl=impl)
    else:
        out = full_attention(bp["mixer"], x, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads,
                             head_dim=cfg.resolved_head_dim,
                             rope_theta=cfg.rope_theta,
                             rope_fraction=cfg.rope_fraction, causal=causal,
                             chunk_q=cfg.attn_chunk_q, impl=impl)
    if ffn is None:
        return h + out, 0.0
    return _ffn(cfg, bp, h + out, ffn)


def _whisper_layer(cfg: ModelConfig, bp, h, enc, impl: str):
    """One whisper decoder layer over the full sequence: causal
    self-attention (ln1; learned positions, no rope), cross-attention over
    the encoder output ``enc`` (ln3), then the GELU MLP (ln2)."""
    bp = cast_tree(bp, _cdt(cfg))
    dims = dict(n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim)
    x = layer_norm(h, bp["ln1"], bp["ln1_b"], cfg.norm_eps)
    h = h + full_attention(bp["mixer"], x, n_heads=cfg.n_heads,
                           rope_fraction=0.0, causal=True,
                           chunk_q=cfg.attn_chunk_q, impl=impl, **dims)
    x = layer_norm(h, bp["ln3"], bp["ln3_b"], cfg.norm_eps)
    kv = cross_kv(bp["cross"], enc, **dims)
    h = h + cross_attention(bp["cross"], x, kv, n_heads=cfg.n_heads, **dims)
    x = layer_norm(h, bp["ln2"], bp["ln2_b"], cfg.norm_eps)
    return h + mlp(bp["ffn"], x, cfg.act)


def _encode(cfg: ModelConfig, params, frames, impl: str = "cuda"):
    """Whisper's encoder over precomputed frame embeddings [B,T,D]: plus
    ``enc_pos_emb``, in the compute type, then the non-causal layers and
    the final layer norm, in the compute type."""
    cdt = _cdt(cfg)
    pos = params["enc_pos_emb"]
    h = (torch.as_tensor(frames, device=pos.device).to(cdt)
         + pos[None].to(cdt))
    for l in range(cfg.encoder.n_layers):
        h, _ = _block(cfg, _layer(params["enc_blocks"], l), h, "attn",
                      "dense", impl, causal=False)
    return layer_norm(h, params["enc_norm"], params["enc_norm_b"],
                      cfg.norm_eps).to(cdt)


def _splice(h, patch_embeds):
    """The VLM stub frontend: ``patch_embeds`` [B,P,D], in h's type, in
    place of the first P token embeddings, written out of place (a
    training step's autograd never sees an in-place write into the
    embedding gather)."""
    pe = torch.as_tensor(patch_embeds, device=h.device).to(h.dtype)
    P, S = pe.shape[1], h.shape[1]
    if P > S:
        raise ValueError(f"{P} patch embeddings do not fit a sequence of {S} "
                         f"tokens: the splice replaces the first P token "
                         f"embeddings, so S >= P (the reference's "
                         f"dynamic_update_slice refuses this shape too)")
    return torch.cat([pe, h[:, P:]], dim=1)


def _embed_tokens(cfg: ModelConfig, params, tokens):
    """The token embeddings in the compute type: a row gather. A DTensor
    table takes the vocab-parallel gather GSPMD makes of it, by hand on
    the local shards (DTensor's own leaves a masked partial sum that some
    torch releases cannot reduce later): each rank reads the rows of its
    vocab shard, zeros the others, and the rows are all-reduced."""
    emb = params["embed"]
    if is_dtensor(emb):
        return _vocab_parallel_rows(emb, tokens).to(_cdt(cfg))
    idx = torch.as_tensor(tokens, device=emb.device).long()
    return emb[idx].to(_cdt(cfg))


def _vocab_parallel_rows(emb, tokens):
    """The rows of the DTensor table ``emb`` [V, D] (vocab-sharded) for
    ``tokens``, replicated on the vocab's mesh dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = emb.device_mesh
    table = replicate_dims(emb, [1])
    vocab = [m for m, p in enumerate(table.placements) if p.is_shard()]
    if is_dtensor(tokens):
        tok_pl = [Replicate() if m in vocab else p
                  for m, p in enumerate(tokens.placements)]
        tok = tokens.redistribute(mesh, tok_pl).to_local()
    else:
        tok_pl, tok = [Replicate()] * mesh.ndim, tokens
    local = table.to_local()         # the vocab tiles evenly (_sanitize)
    n, coord, shard_no = local.shape[0], mesh.get_coordinate(), 0
    for m in vocab:
        shard_no = shard_no * mesh.size(m) + coord[m]
    idx = tok.long() - shard_no * n
    hit = (idx >= 0) & (idx < n)
    rows = local[idx.clamp(0, n - 1)] * hit[..., None]
    out_pl = [Partial() if m in vocab else (Shard(p.dim) if p.is_shard()
                                            else Replicate())
              for m, p in enumerate(tok_pl)]
    shape = torch.Size((*tokens.shape, emb.shape[1]))
    y = DTensor.from_local(rows, mesh, out_pl, run_check=False, shape=shape,
                           stride=torch.empty(shape, device="meta").stride())
    return y.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in out_pl])


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
    alone would move it by up to 2^-9. Under autograd (training) the card
    takes the CPU's fp32 product, which autograd differentiates. ``meta``
    tensors (the launch analysis) take the card's path."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    cdt = _cdt(cfg)
    h = shard(h, ("batch", None, None))
    B, S, D = h.shape
    a, b = h.reshape(B * S, D), w.to(cdt)
    if (cdt == torch.float32 or a.device.type == "cpu"
            or torch.is_grad_enabled() and (a.requires_grad
                                            or b.requires_grad)):
        logits = a.float() @ b.float()
    else:
        hi = a.to(cdt)
        logits = mm(hi, b, out_dtype=torch.float32)
        if a.dtype != cdt:
            lo = (a.float() - hi.float()).to(cdt)
            logits += mm(lo, b, out_dtype=torch.float32)
    return shard(logits.reshape(B, S, -1), ("batch", None, "vocab"))


def backbone(cfg: ModelConfig, params, batch, impl: str = "cuda",
             remat: bool = False):
    """Token embeddings -> (final hidden states [B,S,D], the MoE layers'
    summed balance loss, fp32). ``batch`` is a dict with 'tokens' [B,S]
    plus the family's extras: 'frames' [B, n_frames, D] (audio),
    'patch_embeds' [B, n_patches, D] (VLM)."""
    h = _embed_tokens(cfg, params, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "vlm":
        h = _splice(h, batch["patch_embeds"])
    if cfg.family == "audio":
        h = h + params["pos_emb"][None, :h.shape[1]].to(h.dtype)
        enc = _encode(cfg, params, batch["frames"], impl)
        for l in range(cfg.n_layers):
            h = _run(remat, _whisper_layer, cfg,
                     _layer(params["blocks"], l), h, enc, impl)
        return layer_norm(h, params["final_norm"], params["final_norm_b"],
                          cfg.norm_eps), aux
    for bp, mixer, ffn, _ in _layers(cfg, params):
        h, a = _run(remat, _block, cfg, bp, h, mixer, ffn, impl)
        aux = aux + a
    return rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def train_logits(cfg: ModelConfig, params, batch, remat: bool = True):
    """(fp32 logits [B,S,V], extras): ``extras["aux_loss"]`` is the MoE
    balance loss (0 without MoE), and for deepseek-v3 ``"mtp_logits"``
    predict token t+2 from hidden t and the embedding of token t+1 (the
    embeddings rolled by one, the last position wrapping as ``jnp.roll``
    does), through the two RMS norms, ``proj`` and one dense block.
    Training runs the plain path, ``impl="torch"``: the kernels have no
    backward (their wrappers refuse an input that requires grad)."""
    h, aux = backbone(cfg, params, batch, "torch", remat)
    extras = {"aux_loss": aux}
    logits = _unembed(cfg, params, h)
    if cfg.mtp and "mtp" in params:
        mp = params["mtp"]
        emb_next = roll_left(_embed_tokens(cfg, params, batch["tokens"]))
        x = matmul(torch.cat(
            [rms_norm(h, mp["norm_h"].to(h.dtype), cfg.norm_eps),
             rms_norm(emb_next, mp["norm_e"].to(h.dtype), cfg.norm_eps)],
            dim=-1), mp["proj"].to(h.dtype))
        x, _ = _block(cfg, mp["block"], x, "attn", "dense", "torch")
        extras["mtp_logits"] = _unembed(cfg, params, x)
    return logits, extras


def prefill(cfg: ModelConfig, params, batch, impl: str = "cuda"):
    """Full-sequence forward producing fp32 logits [B,S,V]. ``impl="cuda"``
    runs every attention layer's core (whisper's encoder and decoder
    self-attention too) through ``flash_attention``; ``impl="torch"``
    through the reference's plain path. Mamba layers run the same plain
    SSD under both, and whisper's cross-attention is plain on both, as in
    the reference."""
    return _unembed(cfg, params, backbone(cfg, params, batch, impl)[0])


# ---------------------------------------------------------------------------
# decode: cache init + one-token step


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zeroed decode cache in bfloat16 (the reference's CACHE_DTYPE,
    whatever the compute type), the SSM state in fp32. Dense: {"attn":
    {"k", "v"}}, each [n_layers, batch, max_seq, n_kv_heads, head_dim].
    MLA: the latent {"ckv": [n, batch, max_seq, kv_lora_rank], "kr": [n,
    batch, max_seq, rope_dim]} a stack: "dense" for the dense-first
    layers, "moe" for the rest. SSM: {"mamba": {"conv": [n_layers, batch,
    d_conv - 1, d_xbc], "ssm": [n_layers, batch, H, P, N]}}. Hybrid: the
    KV cache of each period's attention layer ({"attn"}, [n_periods,
    ...]) and "conv" / "ssm" of its other layers, [n_periods, period - 1,
    batch, ...]. Audio: the decoder's {"self": {"k", "v"}}, [n_layers,
    batch, max_seq, n_kv_heads, head_dim], and "cross_k" / "cross_v",
    [n_layers, batch, n_frames, n_kv_heads, head_dim]: zeros until the
    caller writes the encoder's keys and values there (``cross_kv`` of
    ``_encode``'s output, layer by layer), as in the reference. The VLM
    family decodes as the dense family: its patches enter through
    prefill only. ``device="meta"`` gives the same tree with no memory
    (the reference's ``mode="specs"``)."""
    dev = resolve(device, allow_meta=True)
    zeros = lambda *s: torch.zeros(s, dtype=CACHE_DTYPE,  # noqa: E731
                                   device=dev)
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.family == "audio":
        shape = (cfg.n_layers, batch, max_seq) + kv
        cross = (cfg.n_layers, batch, cfg.encoder.n_frames) + kv
        return {"self": {"k": zeros(*shape), "v": zeros(*shape)},
                "cross_k": zeros(*cross), "cross_v": zeros(*cross)}
    if cfg.ssm is not None:
        _, H, d_xbc = mamba_dims(cfg.d_model, cfg.ssm)
        state = (batch, H, cfg.ssm.head_dim, cfg.ssm.d_state)
        lead = ((cfg.n_layers,) if not cfg.hybrid_attn_period else
                (cfg.n_layers // cfg.hybrid_attn_period,
                 cfg.hybrid_attn_period - 1))
        mamba = {"conv": zeros(*lead, batch, cfg.ssm.d_conv - 1, d_xbc),
                 "ssm": torch.zeros(lead + state, dtype=torch.float32,
                                    device=dev)}
        if not cfg.hybrid_attn_period:
            return {"mamba": mamba}
        shape = (lead[0], batch, max_seq) + kv
        return {"attn": {"k": zeros(*shape), "v": zeros(*shape)}, **mamba}
    if cfg.mla is not None:
        return {ckey: {"ckv": zeros(n, batch, max_seq, cfg.mla.kv_lora_rank),
                       "kr": zeros(n, batch, max_seq,
                                   cfg.mla.qk_rope_head_dim)}
                for _, ckey, n, _, _ in _stacks(cfg)}
    shape = (cfg.n_layers, batch, max_seq) + kv
    return {"attn": {"k": zeros(*shape), "v": zeros(*shape)}}


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token [B,1] ints; pos an int. Returns (logits [B,1,V], cache), the
    cache updated in place at ``pos`` (the reference returns a copy); a
    Mamba layer's conv window (fp32 inside the step) is stored back in
    the cache's bf16, its state in fp32."""
    h = _embed_tokens(cfg, params, token)
    if cfg.family == "audio":
        return _whisper_decode_step(cfg, params, cache, h, pos)
    for bp, mixer, ffn, c in _layers(cfg, params, cache):
        bp = cast_tree(bp, _cdt(cfg))
        x = _norm_in(cfg, bp, h, "ln1")
        if mixer == "mamba":
            out, new = mamba_decode(bp["mixer"], x, c, cfg.d_model, cfg.ssm)
            c["conv"].copy_(new["conv"])
            c["ssm"].copy_(new["ssm"])
        elif cfg.mla is not None:
            out, _, _ = mla_decode(
                bp["mixer"], x, c["ckv"], c["kr"], pos,
                n_heads=cfg.n_heads, mla=cfg.mla, rope_theta=cfg.rope_theta)
        else:
            out, _, _ = decode_attention(
                bp["mixer"], x, c["k"], c["v"], pos, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction)
        h = h + out
        if ffn is not None:
            h, _ = _ffn(cfg, bp, h, ffn)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h), cache


def _whisper_decode_step(cfg: ModelConfig, params, cache, h, pos):
    """decode_step's audio branch: ``pos_emb[pos]`` added in the
    parameters' type (as the reference adds it uncast, so with fp32
    parameters the residual stream is fp32 from here), then per layer
    self-attention over the "self" cache (no rope), cross-attention over
    "cross_k" / "cross_v" and the MLP, then the final layer norm."""
    h = h + params["pos_emb"][int(pos)][None, None]
    dims = dict(n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim)
    for l in range(cfg.n_layers):
        bp = cast_tree(_layer(params["blocks"], l), _cdt(cfg))
        x = layer_norm(h, bp["ln1"], bp["ln1_b"], cfg.norm_eps)
        out, _, _ = decode_attention(
            bp["mixer"], x, cache["self"]["k"][l], cache["self"]["v"][l],
            pos, n_heads=cfg.n_heads, rope_fraction=0.0, **dims)
        h = h + out
        x = layer_norm(h, bp["ln3"], bp["ln3_b"], cfg.norm_eps)
        h = h + cross_attention(
            bp["cross"], x, (cache["cross_k"][l], cache["cross_v"][l]),
            n_heads=cfg.n_heads, **dims)
        x = layer_norm(h, bp["ln2"], bp["ln2_b"], cfg.norm_eps)
        h = h + mlp(bp["ffn"], x, cfg.act)
    h = layer_norm(h, params["final_norm"], params["final_norm_b"],
                   cfg.norm_eps)
    return _unembed(cfg, params, h), cache
