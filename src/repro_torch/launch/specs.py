"""Inputs of every (arch x shape) cell, the counterpart of
``repro.launch.specs``: ``meta`` tensors in mode "specs" (shapes and types,
no memory: the reference's ``ShapeDtypeStruct`` stand-ins), else the
reference's random batches, drawn by ``np.random.default_rng(seed)`` in
the reference's order so they are bitwise the reference's, on ``device``
(the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.devices import resolve
from repro_torch.models.transformer import init_cache

_TORCH = {np.dtype(np.int32): torch.int32,
          np.dtype(np.float32): torch.float32}


def _mk(mode, rng, shape, dtype, maxval=None, device="cuda"):
    if mode == "specs":
        return torch.empty(shape, dtype=_TORCH[np.dtype(dtype)],
                           device="meta")
    if np.issubdtype(dtype, np.integer):
        a = rng.integers(0, maxval or 2, size=shape, dtype=np.int32)
    else:
        a = rng.standard_normal(shape).astype(dtype)
    return torch.from_numpy(a).to(resolve(device))


def train_specs(cfg: ModelConfig, shape: ShapeConfig, mode="specs",
                seed=0, device="cuda") -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    kw = dict(device=device)
    d = {
        "tokens": _mk(mode, rng, (B, S), np.int32, cfg.vocab_size, **kw),
        "labels": _mk(mode, rng, (B, S), np.int32, cfg.vocab_size, **kw),
    }
    if cfg.family == "audio":
        d["frames"] = _mk(mode, rng, (B, cfg.encoder.n_frames, cfg.d_model),
                          np.float32, **kw)
    if cfg.family == "vlm":
        d["patch_embeds"] = _mk(mode, rng,
                                (B, cfg.vision.n_patches, cfg.d_model),
                                np.float32, **kw)
    return d


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, mode="specs",
                  seed=0, device="cuda") -> Dict[str, Any]:
    d = train_specs(cfg, shape, mode, seed, device)
    d.pop("labels")
    return d


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mode="specs",
                 seed=0, device="cuda") -> Dict[str, Any]:
    """Inputs of ``decode_step``: one new token, a full cache of seq_len
    (zeros outside mode "specs") and ``pos`` = seq_len - 1, a 0-d int32
    tensor."""
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    specs = mode == "specs"
    dev = "meta" if specs else device
    cache = init_cache(cfg, B, S, device=dev)
    pos = (torch.empty((), dtype=torch.int32, device="meta") if specs
           else torch.tensor(S - 1, dtype=torch.int32,
                             device=resolve(device)))
    return {"token": _mk(mode, rng, (B, 1), np.int32, cfg.vocab_size,
                         device=device),
            "pos": pos, "cache": cache}


def specs_for(cfg: ModelConfig, shape: ShapeConfig, mode="specs", seed=0,
              device="cuda"):
    if shape.kind == "train":
        return train_specs(cfg, shape, mode, seed, device)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape, mode, seed, device)
    return decode_specs(cfg, shape, mode, seed, device)
