"""Decoupled GNN model assembly (paper §2.3 "Specification of Decoupled
model"): L layers, receptive-field size N, PPR sampling (core.ini),
aggregate(), hidden dims f_l, update() weights, and the Readout().

Hidden dims follow the paper's evaluation: f_l = 256 for all layers, so
the L-1 inner layers are homogeneous and their parameters are stacked
along a leading axis of length L-1 (``params["layers"]``), as in the
reference. The first layer maps f_in -> f_hidden.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.program import layer_init_for, lower_and_specialize
from repro_torch.devices import resolve
from repro_torch.gnn.layers import dense_init


@dataclass(frozen=True)
class GNNConfig:
    kind: str                    # gcn | sage | gin | gat | appnp | sgc
    n_layers: int = 3            # L
    receptive_field: int = 128   # N
    f_in: int = 500
    f_hidden: int = 256          # paper: 256 for every layer
    n_heads: int = 4             # gat only (f_hidden % n_heads == 0)
    num_classes: int = 0         # 0 = emit embeddings only
    readout: str = "max"
    ppr_alpha: float = 0.15
    ppr_eps: float = 1e-4
    name: str = ""

    @property
    def display(self) -> str:
        return self.name or f"{self.kind}-L{self.n_layers}-N{self.receptive_field}"


def _init_layer(cfg: GNNConfig, gen, f_in, f_out):
    # per-layer params come from the same registry as the lowering, so a
    # runtime-registered kind is constructible with no edits here
    return layer_init_for(cfg.kind)(cfg, gen, f_in, f_out)


def init_gnn(cfg: GNNConfig, seed: int = 0, device="cuda"):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``:
    drawn on the CPU (the same numbers on every device), then moved to
    ``device`` (the card unless the caller asks for the CPU; "cuda" with
    no card raises). The inner layers are stacked along a leading L-1
    axis. ``device="meta"`` gives the same tree, shapes and types on
    ``meta`` (drawn on the host as for any device, then moved there: the
    GNN weights are a few MB)."""
    device = resolve(device, allow_meta=True)
    gen = torch.Generator().manual_seed(int(seed))
    p = {"layer0": _init_layer(cfg, gen, cfg.f_in, cfg.f_hidden)}
    if cfg.n_layers > 1:
        inner = [_init_layer(cfg, gen, cfg.f_hidden, cfg.f_hidden)
                 for _ in range(cfg.n_layers - 1)]
        p["layers"] = {k: torch.stack([lp[k] for lp in inner])
                       for k in inner[0]}
    if cfg.num_classes:
        p["cls_w"] = dense_init(gen, (cfg.f_hidden, cfg.num_classes))
        p["cls_b"] = torch.zeros((cfg.num_classes,))
    return params_to(p, device)


def params_to(tree, device):
    """Move a parameter tree (nested dicts of tensors) to ``device``."""
    if isinstance(tree, Mapping):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def params_from_jax(tree, device="cuda"):
    """The reference's ``repro.gnn.model.init_gnn`` tree, given as numpy
    arrays (or anything ``np.asarray`` reads), as this package's parameter
    tree on ``device``: ``layer0``, the stacked ``layers`` with their
    leading L-1 axis, 0-d scalars (gin's ``eps``, appnp's ``teleport``)
    and ``cls_w``/``cls_b``, each copied as float32 unless integral."""
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def gnn_forward(cfg: GNNConfig, params, batch, mode: str = "dense",
                impl: str = "cuda"):
    """batch: device dict of tensors. Returns (embeddings [C, f_hidden or
    num_classes], final h [C,N,f]). Lowers ``cfg`` through the model
    registry, forces every mux'd op to ``mode``, and executes."""
    from repro_torch.core.program import execute
    prog, _ = lower_and_specialize(cfg, force=mode)
    return execute(prog, params, batch, impl=impl)



# the paper's evaluated sweep (§5.2): 3 models x L in {3,5,8,16} x
# N in {64,128,256}, hidden 256
PAPER_MODELS = ("gcn", "sage", "gat")
PAPER_LAYERS = (3, 5, 8, 16)
PAPER_N = (64, 128, 256)


def paper_model_grid(f_in: int = 500, num_classes: int = 0):
    for kind in PAPER_MODELS:
        for L in PAPER_LAYERS:
            for N in PAPER_N:
                yield GNNConfig(kind=kind, n_layers=L, receptive_field=N,
                                f_in=f_in, num_classes=num_classes)
