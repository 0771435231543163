"""Decoupled-GNN training (node classification on subgraph batches), the
PyTorch counterpart of ``repro.gnn.train``.

shaDow-style training: each target's loss comes from its decoupled
receptive field through the inference program itself (``gnn_forward`` in
dense mode), and the gradients from autograd. The forward is the plain
``impl="torch"`` program, as the reference's is ``impl="xla"``: the
hand-written kernels have no backward (the reference's Pallas kernels have
no VJP either), and their wrappers refuse an input that requires grad.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.subgraph import build_batch
from repro_torch.devices import resolve
from repro_torch.gnn.model import GNNConfig, gnn_forward, init_gnn
from repro_torch.graphs.csr import CSRGraph
from repro_torch.train.optim import (AdamWConfig, apply_updates, init_opt,
                                     value_and_grad)

BATCH_KEYS = ("feats", "adj", "adj_mean", "mask")


def _build(g: CSRGraph, cfg: GNNConfig, targets):
    """The reference's host side of a training batch: INI + build on 4
    threads."""
    return build_batch(g, targets, cfg.receptive_field, num_threads=4,
                       alpha=cfg.ppr_alpha, eps=cfg.ppr_eps)


def _to_device(g: CSRGraph, sb, targets, dev):
    batch = {k: torch.from_numpy(getattr(sb, k)).to(dev) for k in BATCH_KEYS}
    labels = torch.from_numpy(
        g.labels[np.asarray(targets).astype(np.int64)].astype(np.int64))
    return batch, labels.to(dev)


def train_batch(g: CSRGraph, cfg: GNNConfig, targets, device):
    """The training batch of ``targets`` as tensors on ``device`` (the
    dict ``feats``, ``adj``, ``adj_mean``, ``mask``) and its int64
    labels."""
    return _to_device(g, _build(g, cfg, targets), targets,
                      torch.device(device))


def gnn_loss(cfg: GNNConfig, params, batch, labels):
    """(mean NLL of the log-softmax, accuracy) of the dense plain
    program's logits."""
    logits, _ = gnn_forward(cfg, params, batch, mode="dense", impl="torch")
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll.mean(), acc


def gnn_grads(cfg: GNNConfig, params, batch, labels):
    """(loss, acc, gradients as a tree of ``params``' layout) by
    ``torch.autograd.grad`` over the parameter leaves."""
    return value_and_grad(
        lambda p: gnn_loss(cfg, p, batch, labels), params)


def make_gnn_train_step(cfg: GNNConfig, opt_cfg: AdamWConfig,
                        impl: str = "torch"):
    """One step: (params, opt_state, batch, labels) -> (params, opt_state,
    {"loss", "acc", "grad_norm"}). Only ``impl="torch"`` trains: the CUDA
    kernels have no backward."""
    if not cfg.num_classes:
        raise ValueError("training needs num_classes > 0")
    if impl != "torch":
        raise ValueError(f"impl={impl!r}: training runs the plain program "
                         f"(impl='torch'); the CUDA kernels have no "
                         f"backward")

    def step(params, opt_state, batch, labels):
        loss, acc, grads = gnn_grads(cfg, params, batch, labels)
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg)
        return params, opt_state, {"loss": loss, "acc": acc, **om}

    return step


def train_gnn(g: CSRGraph, cfg: GNNConfig, *, steps: int = 200,
              batch_size: int = 32, lr: float = 1e-3, seed: int = 0,
              eval_every: int = 50, log=print, device="cuda") -> Dict:
    """Trains from ``init_gnn(cfg, seed)`` with AdamW (no weight decay) on
    batches of ``batch_size`` targets drawn by
    ``np.random.default_rng(seed)``. Returns params, the per-step history
    (loss, acc, grad_norm), the wall time, and each step's host time
    (``build_s``: the batch's INI and build) and device time (``step_s``:
    the copy, forward, backward and update, to a synchronize)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    params = init_gnn(cfg, seed=seed, device=dev)
    opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0)
    opt_state = init_opt(params, opt_cfg)
    step = make_gnn_train_step(cfg, opt_cfg)
    history: List[dict] = []
    build_s: List[float] = []
    step_s: List[float] = []
    t0 = time.perf_counter()
    for s in range(steps):
        t1 = time.perf_counter()
        targets = rng.integers(0, g.num_vertices, size=batch_size)
        sb = _build(g, cfg, targets)
        t2 = time.perf_counter()
        batch, labels = _to_device(g, sb, targets, dev)
        params, opt_state, m = step(params, opt_state, batch, labels)
        history.append({k: float(v) for k, v in m.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s.append(t2 - t1)
        step_s.append(time.perf_counter() - t2)
        if eval_every and (s + 1) % eval_every == 0:
            recent = history[-eval_every:]
            log(f"  step {s+1}: loss "
                f"{np.mean([h['loss'] for h in recent]):.4f} acc "
                f"{np.mean([h['acc'] for h in recent]):.3f}")
    return {"params": params, "history": history,
            "wall_s": time.perf_counter() - t0, "build_s": build_s,
            "step_s": step_s}
