"""Sharding policies, the PyTorch counterpart of
``repro.distributed.sharding``: the devices behind the feature store's
logical shards, logical-axis rules for activations, and path-based specs
for parameters, optimizer moments and decode caches.

A spec is a plain tuple with one entry a tensor dim: a mesh axis name, a
tuple of them (the dim sharded over each, major first), or None, as the
entries of JAX's ``PartitionSpec``. The rules read only the mesh's axis
names and sizes, so they take a ``DeviceMesh`` or any object with
``.shape[axis]`` and ``.axis_names``. ``placements`` turns a spec into
DTensor placements on a ``DeviceMesh``; ``distribute`` places a tree.

Conventions (single-pod mesh ('data','model'); multi-pod adds 'pod'):
  * batch dims           -> ('pod','data')   (replicated if not divisible)
  * attention heads / ff hidden / vocab / experts -> 'model'
  * FSDP (>=100B archs): the non-'model' matrix dim additionally -> 'data'
  * ZeRO-1: optimizer moments get 'data' added on their largest replicated
    dim even when params don't (update shards over data, params re-gather)
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import resolve
from repro_torch.launch.mesh import axis_names, axis_size, data_axes

BLOCK_KEYS = ("blocks", "dense_blocks", "enc_blocks")


def shard_devices(num_shards: int, device="cuda") -> List[torch.device]:
    """One ``torch.device`` per logical feature-store shard.

    On a CUDA ``device``: ``cuda:0 .. cuda:k-1`` when the host has at least
    ``num_shards`` cards; otherwise the shards are simulated, every table
    on ``device`` itself but each under its own budget and placement (the
    store's ``simulated`` flag reports which regime is active). On the CPU:
    ``cpu`` k times. Shard 0 is the target: the device the engine's program
    runs on."""
    dev = resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= num_shards \
            and (dev.index or 0) == 0:
        return [torch.device("cuda", i) for i in range(num_shards)]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * num_shards


def activation_rules(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Logical axis -> mesh axis mapping for ``models.common.shard()``."""
    da = data_axes(mesh)
    n_model = axis_size(mesh, "model")

    def if_div(n, axis="model"):
        return axis if (n and n % n_model == 0) else None

    return {
        "batch": da,
        # heads stay on 'model' even when uneven (DTensor shards unevenly,
        # as GSPMD pads); kv heads are small: replicate unless they divide
        "heads": "model" if cfg.n_heads else None,
        "kv_heads": if_div(cfg.n_kv_heads),
        "ff": "model",
        "vocab": "model",
        "experts": if_div(cfg.moe.num_experts) if cfg.moe else None,
        # inner-expert ff dim: shard over 'model' ONLY when experts aren't
        # (both on 'model' would be a duplicate-axis spec)
        "expert_ff": ("model" if cfg.moe and not if_div(cfg.moe.num_experts)
                      else None),
    }


def batch_spec(global_batch: int, mesh) -> tuple:
    da = data_axes(mesh)
    n = int(np.prod([axis_size(mesh, a) for a in da]))
    if global_batch % n == 0:
        return (da if len(da) > 1 else da[0],)   # PartitionSpec's form
    if global_batch % axis_size(mesh, "data") == 0:
        return ("data",)
    return (None,)


# ---------------------------------------------------------------------------
# parameter specs

_IN_OUT = {  # name -> (spec for 2D [in, out]-style matrices)
    # attention / generic projections: [d_in, sharded_out]
    "wq": "in_out", "wk": "in_out", "wv": "in_out",
    "w_gate": "in_out", "w_up": "in_out", "w_in": "in_out",
    "in_proj": "in_out", "w_uq": "in_out",
    # output projections: [sharded_in, d_out]
    "wo": "out_in", "w_down": "out_in", "w_out": "out_in",
    "out_proj": "out_in",
}


def _param_spec(cfg: ModelConfig, name: str, shape, fsdp_axis) -> tuple:
    """Spec for the *unstacked* param."""
    nd = len(shape)
    if name == "embed":
        return ("model", fsdp_axis)
    if name == "lm_head":
        return (fsdp_axis, "model")
    if name in ("pos_emb", "enc_pos_emb"):
        return (None, None)
    if name == "router":
        return (None, None)
    if name == "conv_w":
        return (None, "model")
    if name in ("conv_b", "b_in", "bq", "bk", "bv"):
        return ("model",)
    if name in ("w_dkv", "w_kr", "w_dq"):             # MLA down-proj [D, r]
        return (fsdp_axis, None)
    if name in ("w_uk", "w_uv"):                      # MLA up-proj [r, H*d]
        return (None, "model")
    if name == "proj":                                # MTP [2D, D]
        return (fsdp_axis, None)
    kind = _IN_OUT.get(name)
    if kind and nd == 2:
        return (fsdp_axis, "model") if kind == "in_out" \
            else ("model", fsdp_axis)
    if kind and nd == 3:                              # MoE expert stacks
        return (("model", fsdp_axis, None) if kind == "in_out"
                else ("model", None, fsdp_axis))
    return (None,) * nd                               # norms, scalars, bias


def _sanitize(spec: tuple, shape, mesh) -> tuple:
    """Drop axis assignments whose dimension doesn't divide evenly: an
    argument's shards must tile it exactly (the reference's pjit rule; an
    activation constraint may shard unevenly). E.g. whisper's vocab 51865
    cannot shard 16-ways."""
    if mesh is None:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, a in enumerate(parts):
        if a is None:
            out.append(None)
            continue
        axes = (a,) if isinstance(a, str) else tuple(a)
        n = int(np.prod([axis_size(mesh, x) for x in axes]))
        out.append(a if shape[dim] % n == 0 else None)
    return tuple(out)


def _map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict (or NamedTuple) of leaves,
    keeping the tree's structure; ``path`` is the tuple of keys."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    return fn(path, tree)


def _zip_tree(fn, a, b, path=()):
    """``fn(path, leaf_a, leaf_b)`` over two trees of one structure."""
    if isinstance(a, Mapping):
        return {k: _zip_tree(fn, a[k], b[k], path + (k,)) for k in a}
    return fn(path, a, b)


def param_pspecs(cfg: ModelConfig, params_tree, mesh=None):
    """A spec tree matching ``params_tree`` (tensors, meta or not)."""
    fsdp_axis = "data" if cfg.sharding.fsdp else None

    def visit(path, leaf):
        stacked = any(n in BLOCK_KEYS for n in path)
        shape = tuple(leaf.shape)
        base_shape = shape[1:] if stacked else shape
        spec = _sanitize(_param_spec(cfg, path[-1], base_shape, fsdp_axis),
                         base_shape, mesh)
        return (None,) + spec if stacked else spec

    return _map_tree(visit, params_tree)


def cache_pspecs(cfg: ModelConfig, cache_tree, mesh, global_batch: int):
    """Decode-cache specs: batch over data axes; head-ish dims over model
    when divisible. Cache leaves are [L, B, ...]."""
    bs = batch_spec(global_batch, mesh)
    b_axis = bs[0] if len(bs) else None
    n_model = axis_size(mesh, "model")
    seq_cp = cfg.sharding.cache_seq_shard

    def visit(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in ("k", "v", "cross_k", "cross_v"):  # [L,B,S,Kh,Dh]
            kh = shape[3]
            if kh % n_model == 0:
                return (None, b_axis, None, "model", None)
            # context parallelism: kv-heads don't divide the model axis
            # (qwen 20H, phi3 10H) -> shard the SEQ dim instead
            if seq_cp and shape[2] % n_model == 0:
                return (None, b_axis, "model", None, None)
            return (None, b_axis, None, None, None)
        if name in ("ckv", "kr"):                     # [L,B,S,r]
            if seq_cp and shape[2] % n_model == 0:
                return (None, b_axis, "model", None)
            return (None, b_axis, None, None)
        if name == "ssm":                             # [..,B,H,P,N]
            h = shape[-3]
            pre = (None,) * (nd - 4)
            return pre + (b_axis, "model" if h % n_model == 0 else None,
                          None, None)
        if name == "conv":                            # [..,B,w,d_xbc]
            pre = (None,) * (nd - 3)
            return pre + (b_axis, None,
                          "model" if shape[-1] % n_model == 0 else None)
        return (None,) * nd

    return _map_tree(visit, cache_tree)


def zero1_pspecs(param_specs, params_tree, mesh):
    """Moment specs: add 'data' on the largest still-replicated dim."""
    n_data = axis_size(mesh, "data")

    def visit(path, spec, leaf):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if any(p == "data" or (isinstance(p, tuple) and "data" in p)
               for p in parts):
            return tuple(parts)       # FSDP already shards over 'data'
        # pick largest replicated dim divisible by n_data
        cand = [(shape[i], i) for i in range(len(shape))
                if parts[i] is None and shape[i] % n_data == 0
                and shape[i] >= n_data]
        if not cand:
            return tuple(parts)
        _, i = max(cand)
        parts[i] = "data"
        return tuple(parts)

    return _zip_tree(visit, param_specs, params_tree)


# ---------------------------------------------------------------------------
# specs -> DTensor placements


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: mesh
    dim ``m`` is ``Shard(d)`` where entry ``d`` names its axis (alone or
    in a tuple, so a dim named by ("pod", "data") shards on both), else
    ``Replicate()``. The counterpart of the reference's ``named``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, a in enumerate(spec):
        if a is None:
            continue
        for ax in ((a,) if isinstance(a, str) else tuple(a)):
            m = names.index(ax)
            if out[m] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {ax!r} named "
                                 f"twice")
            out[m] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each leaf of ``tree`` as a DTensor on ``mesh``, placed by the spec
    at the same path of ``specs``. A leaf on ``meta`` stays there: its
    local shard is an empty ``meta`` tensor of the shard's shape."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, leaf, spec):
        return distribute_tensor(leaf, mesh, placements(spec, mesh))

    if isinstance(tree, Mapping):
        return {k: distribute(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(getattr(tree, f), getattr(specs, f),
                                       mesh) for f in tree._fields))
    return one((), tree, specs)


__all__ = ["BLOCK_KEYS", "activation_rules", "batch_spec", "cache_pspecs",
           "distribute", "param_pspecs", "placements", "shard_devices",
           "zero1_pspecs"]
