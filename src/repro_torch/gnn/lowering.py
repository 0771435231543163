"""Builtin model lowerings: GNN kind -> ACK instruction stream.

Each lowering maps one GNN variant onto the typed op vocabulary in
``core.program`` (the paper's kernel taxonomy). The registry entry also
carries the per-layer parameter initializer, so a kind registered here —
or at runtime by a user — is immediately constructible (``init_gnn``)
and servable (``DecoupledEngine``), with no engine/model edits.

The lowering table (layer template; layer0 and inner layers share it,
differing only in feature widths):

  gcn   Aggregate[gcn]    -> Transform[w]            (relu)
  sage  Aggregate[mean]   -> Transform[w_neigh + w_self]  (relu)
  gin   Aggregate[binary] -> Residual[(1+eps) h]
                          -> Transform[w1] -> Transform[w2]   (relu, relu)
  gat   Transform[w] (none) -> AttentionScore -> AttentionSoftmax (elu)
  appnp layer0: Transform[w] (relu)   — the prediction MLP
        inner:  Aggregate[gcn] -> Residual[(1+teleport) h0, gain 1-a]
        (propagation-only inner template: NO Transform — h' =
        (1-a) A_hat h + (1+teleport) h0, the exact APPNP power step)
  sgc   layer0: Transform[w] (none)   — the single linear map
        inner:  Aggregate[gcn]        — pure propagation, K = L-1 steps
        (h_L = S^(L-1) (X W) == (S^(L-1) X) W: the SGC S^K X W recurrence
        with the transform hoisted in front by associativity)

Tail: Readout[cfg.readout] and, when ``cfg.num_classes`` is set, Classify.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.program import (AckOp, AckProgram, Aggregate,
                                AttentionScore, AttentionSoftmax, Classify,
                                Readout, Residual, Transform,
                                register_lowering)
from repro_torch.gnn.layers import (init_appnp_layer, init_gat_layer,
                              init_gcn_layer, init_gin_layer,
                              init_sage_layer, init_sgc_layer)


def _tail(cfg) -> Tuple[AckOp, ...]:
    tail: Tuple[AckOp, ...] = (Readout(kind=cfg.readout),)
    if cfg.num_classes:
        tail += (Classify(),)
    return tail


def _program(cfg, layer_ops: Tuple[AckOp, ...]) -> AckProgram:
    return AckProgram(kind=cfg.kind, layer0=layer_ops, inner=layer_ops,
                      tail=_tail(cfg), n_layers=cfg.n_layers)


@register_lowering("gcn",
                   layer_init=lambda cfg, gen, fi, fo:
                   init_gcn_layer(gen, fi, fo))
def lower_gcn(cfg) -> AckProgram:
    return _program(cfg, (
        Aggregate(norm="gcn"),
        Transform(w="w", b="b", act="relu"),
    ))


@register_lowering("sage",
                   layer_init=lambda cfg, gen, fi, fo:
                   init_sage_layer(gen, fi, fo))
def lower_sage(cfg) -> AckProgram:
    return _program(cfg, (
        Aggregate(norm="mean"),
        Transform(w="w_neigh", w_self="w_self", b="b", act="relu"),
    ))


@register_lowering("gin",
                   layer_init=lambda cfg, gen, fi, fo:
                   init_gin_layer(gen, fi, fo))
def lower_gin(cfg) -> AckProgram:
    return _program(cfg, (
        Aggregate(norm="binary"),
        Residual(src="h_in", into="z", eps_param="eps"),
        Transform(w="w1", b="b1", act="relu", src="z", out="h2",
                  masked=False),
        Transform(w="w2", b="b2", act="relu", src="h2", out="h"),
    ))


@register_lowering("appnp",
                   layer_init=lambda cfg, gen, fi, fo:
                   init_appnp_layer(gen, fi, fo, cfg.ppr_alpha))
def lower_appnp(cfg) -> AckProgram:
    """Predict-then-propagate: layer0 is the MLP, every inner layer is a
    PROPAGATION-ONLY template (Aggregate + teleport Residual, no
    Transform) — the op-vocabulary stress case: a layer section with no
    weight matmul, whose mux'd Aggregate still gets its own dense/sg
    decision. The Residual teleports to the ``h0`` register (the
    post-layer0 prediction) with into_gain = 1 - alpha: h' =
    (1-a) A_hat h + (1+teleport) h0, the exact APPNP power step at the
    initializer's 1 + teleport = alpha."""
    return AckProgram(kind=cfg.kind, layer0=(
        Transform(w="w", b="b", act="relu", src="h", out="h"),
    ), inner=(
        Aggregate(norm="gcn", src="h", out="h"),
        Residual(src="h0", into="h", eps_param="teleport",
                 into_gain=1.0 - cfg.ppr_alpha),
    ), tail=_tail(cfg), n_layers=cfg.n_layers)


@register_lowering("sgc",
                   layer_init=lambda cfg, gen, fi, fo:
                   init_sgc_layer(gen, fi, fo))
def lower_sgc(cfg) -> AckProgram:
    """Simplified GCN (SGC): K propagation steps and ONE linear map —
    logits = S^K X W, no nonlinearity between steps. Lowered
    transform-first (layer0 applies W, every inner layer is a pure
    Aggregate[gcn] propagation): h_L = S^(L-1) (X W), which equals the
    canonical (S^(L-1) X) W by matmul associativity — so an L-layer sgc
    program runs K = L-1 SGC propagation steps exactly, and the inner
    Aggregate still gets its own dense/sg mux (a second propagation-only
    template next to APPNP, with no Residual at all)."""
    return AckProgram(kind=cfg.kind, layer0=(
        Transform(w="w", b=None, act="none", src="h", out="h"),
    ), inner=(
        Aggregate(norm="gcn", src="h", out="h"),
    ), tail=_tail(cfg), n_layers=cfg.n_layers)


@register_lowering("gat",
                   layer_init=lambda cfg, gen, fi, fo:
                   init_gat_layer(gen, fi, fo, cfg.n_heads))
def lower_gat(cfg) -> AckProgram:
    return _program(cfg, (
        Transform(w="w", b=None, act="none", src="h", out="z",
                  masked=False),
        AttentionScore(n_heads=cfg.n_heads),
        AttentionSoftmax(b="b", act="elu", n_heads=cfg.n_heads),
    ))
