"""Dry-run cell builders, the counterpart of ``repro.launch.cells``: one
``(fn, args)`` pair per (arch x shape) cell, plus GNN serve cells for the
paper's own models.

The arguments are ``meta`` tensors (shapes and types, no memory) placed by
the ported rules as DTensors on ``mesh``: parameters by ``param_pspecs``,
AdamW moments by ``zero1_pspecs``, the decode cache by ``cache_pspecs`` and
the batch by ``batch_spec``. With ``mesh=None`` they stay plain ``meta``
tensors: one device's whole cell. ``fn`` runs under
``logical_axis_rules(activation_rules(cfg, mesh))`` and DTensor's
``implicit_replication()`` (the models build plain tensors, rope tables
and masks, that meet DTensors). ``fn.donate`` names the arguments whose
buffers the outputs may alias (the reference's ``donate_argnums``): the
memory record counts an output that is one of them as an alias, not as
new memory.

Used by ``launch.dryrun`` (count each cell under ``launch.op_analysis``)
and ``chip_smoke.py``'s ``[launch]`` phase (the same cells on one card).
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (activation_rules, batch_spec,
                                              cache_pspecs, distribute,
                                              param_pspecs, zero1_pspecs)
from repro_torch.gnn.model import GNNConfig, gnn_forward, init_gnn
from repro_torch.launch.mesh import axis_names, axis_size, data_axes
from repro_torch.launch.specs import specs_for
from repro_torch.models.common import logical_axis_rules
from repro_torch.models.transformer import decode_step, init_params, prefill
from repro_torch.train.optim import AdamWConfig, OptState, init_opt
from repro_torch.train.step import make_train_step


@contextlib.contextmanager
def _replicating(mesh):
    """DTensor's implicit replication of plain tensors on ``mesh``;
    nothing without one."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


@contextlib.contextmanager
def _sharded(cfg, mesh):
    """The activation rules and implicit replication of a cell on
    ``mesh``; nothing without one."""
    if mesh is None:
        yield
        return
    with logical_axis_rules(activation_rules(cfg, mesh)), \
            _replicating(mesh):
        yield


def _place(tree, specs, mesh):
    return tree if mesh is None else distribute(tree, specs, mesh)


def _batch_specs(batch, bspec: tuple):
    """The batch's specs: ``bspec`` on the leading dim of >= 2-d leaves,
    the rest replicated."""
    out = {}
    for k, v in batch.items():
        nd = v.dim()
        out[k] = (bspec + (None,) * (nd - 1)) if nd >= 2 else (None,) * nd
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(fn, args) of one (arch x shape) cell; ``fn(*args)`` runs the
    port's own step: ``make_train_step(cfg, opt_cfg, remat=True)`` (forward
    and backward), or ``prefill`` / ``decode_step`` with ``impl="torch"``,
    as the reference's cells run XLA and no Pallas."""
    # learned-position archs (whisper) need the position table to cover
    # the full cell seq_len; rope archs don't materialize positions
    max_seq = shape.seq_len if cfg.family == "audio" \
        else min(shape.seq_len, 4096)
    params = init_params(cfg, device="meta", max_seq=max_seq)
    pspecs = param_pspecs(cfg, params, mesh)
    bspec = batch_spec(shape.global_batch, mesh) if mesh is not None \
        else (None,)
    p = _place(params, pspecs, mesh)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.dtype.opt_dtype)
        opt = init_opt(params, opt_cfg)
        if mesh is not None:
            mspec = zero1_pspecs(pspecs, params, mesh)
            opt = OptState(step=distribute(opt.step, (), mesh),
                           m=distribute(opt.m, mspec, mesh),
                           v=distribute(opt.v, mspec, mesh))
        batch = specs_for(cfg, shape)
        b = _place(batch, _batch_specs(batch, bspec), mesh)
        step = make_train_step(cfg, opt_cfg, remat=True)

        def fn(p, o, b):
            with _sharded(cfg, mesh):
                return step(p, o, b)
        fn.donate = (0, 1)
        return fn, (p, opt, b)

    if shape.kind == "prefill":
        batch = specs_for(cfg, shape)
        b = _place(batch, _batch_specs(batch, bspec), mesh)

        def fn(p, b):
            with _sharded(cfg, mesh):
                return prefill(cfg, p, b, impl="torch")
        fn.donate = ()
        return fn, (p, b)

    # decode: the cache is updated in place (donated)
    d = specs_for(cfg, shape)
    cache = d["cache"]
    if mesh is not None:
        cache = distribute(cache, cache_pspecs(cfg, cache, mesh,
                                               shape.global_batch), mesh)
    token = _place(d["token"], bspec + (None,), mesh)
    pos = d["pos"]
    # a meta position has no value: the reference's concrete one, S - 1
    at = shape.seq_len - 1 if pos.device.type == "meta" else int(pos)

    def fn(p, cache, token, pos):
        with _sharded(cfg, mesh):
            return decode_step(cfg, p, cache, token, at)
    fn.donate = (1,)
    return fn, (p, cache, token, pos)


# ---------------------------------------------------------------------------
# GNN serve cells (the paper's models on the production mesh)


GNN_SERVE_BATCH = 4096      # targets per global step (16 per card @ 256)


def gnn_batch_specs(cfg: GNNConfig, C: int, f_pad: int = 0,
                    variant: str = "base") -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins of a dense serve batch of C subgraphs: "base"
    ships feats, both adjacencies and the mask in fp32; "opt" ships only
    the adjacency arrays the lowered program reads, in bf16 (weights are
    1/sqrt(deg): bf16's 8-bit mantissa is plenty), and bf16 features."""
    n = cfg.receptive_field
    f = f_pad or cfg.f_in
    mk = lambda shape, dt: torch.empty(shape, dtype=dt,  # noqa: E731
                                       device="meta")
    if variant == "opt":
        from repro_torch.core.program import lower, required_adjacency
        d = {"feats": mk((C, n, f), torch.bfloat16),
             "mask": mk((C, n), torch.float32)}
        for key in required_adjacency(lower(cfg)):
            d[key] = mk((C, n, n), torch.bfloat16)
        return d
    return {"feats": mk((C, n, f), torch.float32),
            "adj": mk((C, n, n), torch.float32),
            "adj_mean": mk((C, n, n), torch.float32),
            "mask": mk((C, n), torch.float32)}


def build_gnn_cell(cfg: GNNConfig, mesh=None, C: int = GNN_SERVE_BATCH,
                   variant: str = "base", impl: str = "torch",
                   params=None, batch=None):
    """(fn, args) of a mini-batch GNN inference step: ``gnn_forward`` in
    dense mode. Targets (the paper's N_pe parallelism) shard over EVERY
    mesh axis when C divides, else over the data axes: the GNN weights are
    tiny and replicated, so the whole mesh is one large PE array. By
    default the arguments are ``meta`` (``init_gnn(device="meta")`` and
    ``gnn_batch_specs``); ``params`` and ``batch`` give real ones (the
    measured cells on the card)."""
    if params is None:
        params = init_gnn(cfg, device="meta")
        if variant == "opt":     # bf16 weights
            params = _cast(params, torch.bfloat16)
    if batch is None:
        batch = gnn_batch_specs(cfg, C, variant=variant)
    if mesh is not None:
        all_axes = axis_names(mesh)
        n_total = int(np.prod([axis_size(mesh, a) for a in all_axes]))
        lead = all_axes if C % n_total == 0 else data_axes(mesh)
        params = distribute(params, _map(lambda t: (None,) * t.dim(),
                                         params), mesh)
        batch = distribute(batch, {k: (lead,) + (None,) * (v.dim() - 1)
                                   for k, v in batch.items()}, mesh)

    def fn(p, b):
        with _replicating(mesh):
            emb, _ = gnn_forward(cfg, p, b, mode="dense", impl=impl)
        return emb
    fn.donate = ()
    return fn, (params, batch)


def _map(f, tree):
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    return f(tree)


def _cast(tree, dtype):
    return _map(lambda t: t.to(dtype), tree)


__all__ = ["GNN_SERVE_BATCH", "build_cell", "build_gnn_cell",
           "gnn_batch_specs"]
