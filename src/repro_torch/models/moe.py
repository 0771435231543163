"""Mixture-of-Experts with sort-based capacity dispatch (fixed shapes), the
PyTorch counterpart of ``repro.models.moe``.

Routing: fp32 logits of fp32 operands, softmax, top-k renormalised, the
Switch load-balance loss. (token, k) pairs are stably sorted by expert id
(``torch.argsort(stable=True)``), ranked within their expert by an
exclusive cumulative count, and placed in a dense per-expert buffer
[E, cap, D]; a pair ranked past ``cap`` is dropped into the extra row
``E * cap``. The experts' SwiGLU FFNs run as batched matmuls over the
expert axis, outside any kernel, as in the reference.

The combine sums each token's k contributions in a fixed order and never
with atomics: ``moe_ffn`` adds them one by one in the reference's order
(its scatter-add visits a token's pairs in sorted order, by expert id),
``moe_ffn_gather`` contracts them as the reference's einsum. So a forward
on the card is bitwise repeatable (``index_add_`` there sums with atomics,
in no fixed order). The scatter into the expert buffer writes each kept
slot once; its only duplicate indices are the drop row's, which is
discarded.

The gather formulation moves tokens into the expert buffer and outputs
back by two gathers, ``routed_dispatch`` and ``routed_combine``: the
``torch.autograd.Function`` pair of the reference's ``custom_vjp`` pair
(``_routed_dispatch``, ``_routed_combine``). The dispatch map (t, i) <->
slot is a partial bijection, so each backward is also a gather, in a fixed
order: no scatter-add (with atomics on the card) enters the gradient. Each
saves only its integer index vectors, through ``save_for_backward`` (so a
``checkpoint`` around the layer recomputes them), and returns None for
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import (dense_init, einsum, full_local,
                                       is_dtensor, matmul, on_replicated,
                                       shard)
from repro_torch.models.mlp import init_mlp, mlp


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(n_tokens * moe.top_k * moe.capacity_factor) // moe.num_experts
    return max(8, c + (-c) % 8)       # a multiple of 8, as the reference


def init_moe(gen, n_layers, d_model, moe: MoEConfig, dtype=torch.float32):
    """Router (fp32 whatever ``dtype``), expert gate/up/down and the shared
    SwiGLU of ``n_layers`` layers, stacked on a leading axis."""
    L, E, Fe = n_layers, moe.num_experts, moe.d_ff_expert
    p = {"router": dense_init(gen, (L, d_model, E), torch.float32),
         "w_gate": dense_init(gen, (L, E, d_model, Fe), dtype),
         "w_up": dense_init(gen, (L, E, d_model, Fe), dtype),
         "w_down": dense_init(gen, (L, E, Fe, d_model), dtype)}
    if moe.num_shared:
        f_sh = moe.d_ff_shared or moe.d_ff_expert * moe.num_shared
        p["shared"] = init_mlp(gen, L, d_model, f_sh, "silu", dtype)
    return p


def route(router_w, x2d, moe: MoEConfig):
    """x2d [T, D] -> (expert ids [T,k] int64, probs [T,k] fp32, aux
    load-balance loss)."""
    logits = x2d.float() @ router_w.float()                  # [T,E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)          # renormalize
    # Switch-style aux loss: E * sum_e f_e * P_e
    T, E = logits.shape
    me = probs.mean(dim=0)
    ce = expert_counts(top_e.reshape(-1), E).float() / (T * moe.top_k)
    return top_e, top_p, E * (me * ce).sum()


def expert_counts(flat_e, E: int):
    """How many of ``flat_e``'s ids name each of the E experts:
    ``bincount``, which has no DTensor strategy and no ``meta`` kernel;
    for a DTensor or a ``meta`` tensor the same counts as an exact
    integer ``scatter_add`` over the ids gathered whole."""
    if flat_e.device.type != "meta" and not is_dtensor(flat_e):
        return torch.bincount(flat_e, minlength=E)
    flat_e = full_local(flat_e)
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))


def dispatch_indices(top_e, n_tokens: int, moe: MoEConfig, cap: int):
    """Sort-based ranking. Returns (dest slot [T*k] in [0, E*cap] where
    E*cap means 'dropped', source token [T*k] in sorted order, perm)."""
    k = moe.top_k
    flat_e = full_local(top_e).reshape(-1)                   # [T*k]
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    counts = expert_counts(flat_e, moe.num_experts)
    starts = torch.cumsum(counts, 0) - counts                # exclusive
    rank = torch.arange(n_tokens * k, device=top_e.device) - starts[sorted_e]
    dest = torch.where(rank < cap, sorted_e * cap + rank,
                       moe.num_experts * cap)
    return dest, perm // k, perm


def _experts(params, eb):
    """eb [E, cap, D] -> [E, cap, D]: each expert's SwiGLU (SiLU whatever
    the config's act, as the reference) as batched matmuls, the expert
    axis on the "experts" rule."""
    eb = shard(eb, ("experts", None, None))
    h = F.silu(matmul(eb, params["w_gate"])) * matmul(eb, params["w_up"])
    h = shard(h, ("experts", None, "expert_ff"))
    return shard(matmul(h, params["w_down"]), ("experts", None, None))


def moe_ffn(params, x, moe: MoEConfig, *, act="silu"):
    """x [B, S, D] -> ([B, S, D], aux_loss): the scatter formulation."""
    B, S, D = x.shape
    T = B * S
    x2d = x.reshape(T, D)
    cap = capacity(T, moe)
    E, k = moe.num_experts, moe.top_k
    top_e, top_p, aux = route(params["router"], x2d, moe)
    dest, tok, perm = dispatch_indices(top_e, T, moe, cap)

    # scatter tokens into the expert buffer (the extra row catches drops);
    # DTensors are gathered whole around the index arithmetic (DTensor has
    # no strategy for the index writes; GSPMD replicates the reference's
    # scatter likewise)
    def scatter(xs):
        buf = xs.new_zeros((E * cap + 1, D))
        buf[dest] = xs[tok]
        return buf[:E * cap].reshape(E, cap, D)

    out_e = _experts(params, on_replicated(scatter, x2d))

    # combine: gather back, weight by router prob, sum over k
    def combine(out_e, top_p):
        flat = torch.cat([out_e.reshape(E * cap, D),
                          out_e.new_zeros((1, D))])
        contrib = flat[dest] * top_p.reshape(-1)[perm][:, None].to(x.dtype)
        # each token's k pairs in sorted (expert) order, added one at a
        # time from the first, as the reference's scatter-add adds them
        by_tok = contrib[torch.argsort(tok, stable=True)].reshape(T, k, D)
        y = by_tok[:, 0]
        for i in range(1, k):
            y = y + by_tok[:, i]
        return y

    y = on_replicated(combine, out_e, top_p)
    if "shared" in params:
        y = y + mlp(params["shared"], x2d, act)
    return y.reshape(B, S, D), aux


def _dispatch_gather(x2d, slot_tok):
    """eb[s] = x2d[slot_tok[s] - 1], rows of 0 for empty slots
    (slot_tok 0)."""
    return x2d[(slot_tok - 1).clamp_min(0)] \
        * (slot_tok > 0)[:, None].to(x2d.dtype)


def _combine_gather(flat, dest_tk):
    """contrib[t*k+i] = flat[dest_tk[t*k+i]], 0 where the pair was dropped
    (dest_tk = len(flat))."""
    n = flat.shape[0]
    return torch.where((dest_tk < n)[:, None], flat[dest_tk.clamp_max(n - 1)],
                       flat.new_zeros(()))


class _RoutedDispatch(torch.autograd.Function):
    """Forward ``_dispatch_gather``; backward the gather dx[t] = sum_i
    g[dest_tk[t*k+i]] (0 for a dropped pair), the k terms added in order."""

    @staticmethod
    def forward(ctx, x2d, slot_tok, dest_tk, k):
        ctx.save_for_backward(dest_tk)
        ctx.k = k
        return _dispatch_gather(x2d, slot_tok)

    @staticmethod
    def backward(ctx, g):
        (dest_tk,) = ctx.saved_tensors
        gt = _combine_gather(g, dest_tk)                     # [T*k, D]
        dx = gt.reshape(-1, ctx.k, g.shape[-1]).sum(dim=1)
        return dx, None, None, None


class _RoutedCombine(torch.autograd.Function):
    """Forward ``_combine_gather``; backward the inverse gather dflat[s] =
    g[slot_pair[s] - 1] (0 for an empty slot)."""

    @staticmethod
    def forward(ctx, flat, dest_tk, slot_pair):
        ctx.save_for_backward(slot_pair)
        return _combine_gather(flat, dest_tk)

    @staticmethod
    def backward(ctx, g):
        (slot_pair,) = ctx.saved_tensors
        return _dispatch_gather(g, slot_pair), None, None


def routed_dispatch(x2d, slot_tok, dest_tk, k):
    return _RoutedDispatch.apply(x2d, slot_tok, dest_tk, k)


def routed_combine(flat, dest_tk, slot_pair):
    return _RoutedCombine.apply(flat, dest_tk, slot_pair)


def moe_ffn_gather(params, x, moe: MoEConfig, *, act="silu"):
    """The gather formulation: only index vectors are scattered (slot ->
    token + 1, (t, i) -> slot, slot -> pair + 1); the tokens reach the
    expert buffer and the outputs come back through ``routed_dispatch`` and
    ``routed_combine``."""
    B, S, D = x.shape
    T = B * S
    x2d = shard(x.reshape(T, D), ("batch", None))
    cap = capacity(T, moe)
    E, k = moe.num_experts, moe.top_k
    top_e, top_p, aux = route(params["router"], x2d, moe)
    dest, tok, perm = dispatch_indices(top_e, T, moe, cap)

    keep = dest < E * cap
    slot_tok = torch.zeros(E * cap, dtype=torch.int64, device=x.device)
    slot_tok[dest[keep]] = tok[keep] + 1                     # 0 = empty
    dest_tk = torch.empty_like(dest)
    dest_tk[perm] = dest                                     # (t, i) -> slot
    slot_pair = torch.zeros_like(slot_tok)
    slot_pair[dest[keep]] = perm[keep] + 1                   # slot -> pair

    eb = routed_dispatch(x2d, slot_tok, dest_tk, k)
    out_e = _experts(params, eb.reshape(E, cap, D)).reshape(E * cap, D)
    contrib = routed_combine(out_e, dest_tk, slot_pair)      # [T*k, D]
    contrib = shard(contrib, ("batch", None))
    w_tok = top_p.reshape(T, k).to(x.dtype)
    y = einsum("tkd,tk->td", contrib.reshape(T, k, D), w_tok)
    y = shard(y, ("batch", None))
    if "shared" in params:
        y = y + mlp(params["shared"], x2d, act)
    return y.reshape(B, S, D), aux


def moe_apply(params, x, moe: MoEConfig, *, act="silu"):
    """Dispatch-implementation mux (scatter, or the gather variant)."""
    fn = moe_ffn_gather if moe.dispatch == "gather" else moe_ffn
    return fn(params, x, moe, act=act)


def moe_ffn_dense_oracle(params, x, moe: MoEConfig, *, act="silu"):
    """Every expert on every token, masked by the routing: O(T*E*F), a test
    oracle (no capacity drop, so it matches where nothing overflows)."""
    B, S, D = x.shape
    T = B * S
    x2d = x.reshape(T, D)
    top_e, top_p, _ = route(params["router"], x2d, moe)
    xe = x2d.expand(moe.num_experts, T, D)
    out_all = _experts(params, xe)                           # [E,T,D]
    w = x2d.new_zeros((T, moe.num_experts))
    w[torch.arange(T, device=x.device)[:, None], top_e] = top_p.to(x.dtype)
    y = einsum("etd,te->td", out_all, w)
    if "shared" in params:
        y = y + mlp(params["shared"], x2d, act)
    return y.reshape(B, S, D)
