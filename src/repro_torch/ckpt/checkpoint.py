"""Checkpointing: atomic and resumable (the PyTorch package's counterpart of
``repro.ckpt.checkpoint``, with the same on-disk layout, so either package
restores the other's steps).

Layout per step:  <dir>/step_000123/
    arrays.npz        flattened leaves (host numpy), keyed by key path
    manifest.json     step, keys, shapes, dtypes, caller's extra metadata
    COMMITTED         written last — restore ignores dirs without it

Atomicity: write into step_xxx.tmp, fsync, rename, then touch COMMITTED.
A crash mid-write leaves only an ignored .tmp. Leaves are torch tensors or
numpy arrays (or Python scalars), in nested dicts, lists, tuples and
NamedTuples; a key path joins dict keys, sequence indices and
".field" for a NamedTuple's fields with "/", as the reference's
``tree_flatten_with_path`` names them (dict keys in sorted order; an
``OptState`` inside a tuple is "1/.step", "1/.m/..."). bf16
leaves are stored as their uint16 bit patterns, the manifest naming the
logical dtype. There is one device, so restore takes no sharding.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{key path: leaf}, dict keys sorted, sequence indices and NamedTuple
    fields in order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(like, leaves: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf replaced from ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves,
                              f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(
            getattr(like, f), leaves, f"{prefix}/.{f}" if prefix else f".{f}")
            for f in like._fields))
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(like)]
        return type(like)(out)
    return leaves[prefix]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array to store, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # ml_dtypes arrays, if given
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    stored = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in stored.items()})
    manifest = {
        "step": step,
        "keys": sorted(stored),
        "shapes": {k: list(a.shape) for k, (a, _) in stored.items()},
        "dtypes": {k: dt for k, (_, dt) in stored.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(final, "COMMITTED"), "w") as f:
        f.write("ok")
    return final


def committed_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _restore_leaf(arr: np.ndarray, saved_dtype: str, like):
    """One stored array in the type (tensor or numpy) and dtype of
    ``like``."""
    bf16 = saved_dtype == "bfloat16" and arr.dtype == np.uint16
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            if bf16 else torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if bf16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        arr = t.float().numpy()
    want = getattr(like, "dtype", arr.dtype)
    return arr if str(want) == str(arr.dtype) else arr.astype(want)


def restore(ckpt_dir: str, like_tree, step: Optional[int] = None
            ) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like_tree`` (tensor leaves come back
    as tensors on the like leaf's device and dtype, others as numpy);
    returns (tree, step, extra)."""
    steps = committed_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves = {}
        for key, like in _flatten(like_tree).items():
            arr = data[key]
            leaves[key] = _restore_leaf(
                arr, manifest["dtypes"].get(key, str(arr.dtype)), like)
    return _unflatten(like_tree, leaves), step, manifest.get("extra", {})


def prune(ckpt_dir: str, keep: int = 3):
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


__all__ = ["save", "restore", "committed_steps", "prune"]
