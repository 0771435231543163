"""AdamW over nested dicts of tensors (the PyTorch counterpart of
``repro.train.optim``; not ``torch.optim.AdamW``).

The reference's update rule, kept as it is: a clip of the gradients' global
norm, bias correction from an integer step, decoupled weight decay on
tensors with ndim >= 2 only, the update's arithmetic in fp32 whatever the
parameters' type, and moments held in ``moment_dtype`` (bf16 moments keep
fp32 update math). Functions are pure: ``apply_updates`` returns new
parameters and a new state and changes neither argument.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.devices import resolve
from repro_torch.models.common import is_dtensor
from repro_torch.models.transformer import params_from_jax


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in JAX's order (keys sorted)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    layout in ``rest``, as a tree of that layout."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def value_and_grad(fn, params):
    """(loss, aux, gradients as a tree of ``params``' layout) of ``fn(
    leaves) -> (loss, aux)`` by ``torch.autograd.grad`` over fresh leaves
    that require grad. A leaf the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = fn(leaves)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(flat, grads)}
    return loss.detach(), aux, tree_map(lambda p: by_id[id(p)], leaves)


def init_opt(params, cfg: AdamWConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def _placed_as(g, m):
    """A DTensor gradient ``g`` redistributed to its moment ``m``'s
    placements before the update's arithmetic (a partial sum over the
    data axes reduce-scattered to the moment's ZeRO-1 shard), so DTensor
    never has to move the moment instead: some torch releases cannot
    redistribute a ``Shard`` to a ``Partial``. ``g`` itself otherwise."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(m.placements):
        return g
    return g.redistribute(m.device_mesh, m.placements)


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics). Runs under
    ``torch.no_grad()``: the update is not part of any graph."""
    with torch.no_grad():
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=step.device),
                              step.float())
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=step.device),
                              step.float())
        mdt = getattr(torch, cfg.moment_dtype)

        def upd(p, g, m, v):
            g32 = _placed_as(g, m).float() * scale
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32.square()
            step_dir = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if p.dim() >= 2:       # decoupled weight decay on matrices only
                step_dir = step_dir + cfg.weight_decay * p.float()
            new_p = p.float() - cfg.lr * step_dir
            return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

        out = tree_map(upd, params, grads, state.m, state.v)
        new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                               for i in range(3))
        return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm}


def opt_state_from_jax(state, device="cuda") -> OptState:
    """The reference's ``OptState`` (its leaves as numpy arrays, or anything
    ``np.asarray`` reads) as this package's, on ``device``: the step as a
    0-d int32 tensor, the moments through ``params_from_jax`` (each keeps
    its type: bf16 moments stay bf16)."""
    dev = resolve(device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return OptState(step=step, m=params_from_jax(state.m, dev),
                    v=params_from_jax(state.v, dev))
