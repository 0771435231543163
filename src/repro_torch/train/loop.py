"""Fault-tolerant LM training loop, the PyTorch counterpart of
``repro.train.loop``.

  * periodic atomic checkpoints (``ckpt/checkpoint.py``, the reference's
    on-disk layout) and resume from the latest one, the deterministic token
    pipeline fast-forwarded to the resume point;
  * a failure injection hook (simulated preemption) that tests use to show
    the loss curve continues across a kill and restore;
  * the straggler-tolerant prefetching pipeline (``data/pipeline.py``);
  * a jsonl log of each step's loss, grad norm and times.

Parameters come from ``init_params(cfg, seed)`` on ``device`` (the card
unless the caller passes ``device="cpu"``); the audio and VLM families get
each step's ``frames`` / ``patch_embeds`` from ``np.random.default_rng(
step)``, as the reference draws them.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenPipelineConfig, token_pipeline
from repro_torch.devices import resolve
from repro_torch.models.transformer import init_params
from repro_torch.train.optim import AdamWConfig, init_opt
from repro_torch.train.step import make_train_step


@dataclass
class TrainJobConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_path: Optional[str] = None
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    keep_ckpts: int = 3


def stub_inputs(cfg: ModelConfig, batch: dict, step: int, global_batch: int):
    """The stub frontends' inputs of step ``step`` (0-based), added to
    ``batch``: random ``frames`` [B, n_frames, D] (audio) or
    ``patch_embeds`` [B, n_patches, D] (VLM), fp32, from
    ``np.random.default_rng(step)``."""
    if cfg.family == "audio":
        batch["frames"] = np.random.default_rng(step).standard_normal(
            (global_batch, cfg.encoder.n_frames, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = np.random.default_rng(step).standard_normal(
            (global_batch, cfg.vision.n_patches, cfg.d_model)
        ).astype(np.float32)
    return batch


def train(cfg: ModelConfig, job: TrainJobConfig,
          opt_cfg: Optional[AdamWConfig] = None,
          fail_at_step: Optional[int] = None,
          step_fn: Optional[Callable] = None, device="cuda"):
    """Runs (or resumes) training; returns (params, opt_state, history).
    Each history record: step (1-based), loss, grad_norm, step_time_s (the
    step to its loss read back) and data_time_s (the batch from the
    pipeline and the stub inputs, on the host).

    ``fail_at_step`` raises RuntimeError after the checkpoint at that step:
    a simulated preemption; calling train() again resumes from the latest
    checkpoint."""
    dev = resolve(device)
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3,
                                     moment_dtype=cfg.dtype.opt_dtype)
    params = init_params(cfg, seed=job.seed, device=dev,
                         max_seq=job.seq_len)
    opt_state = init_opt(params, opt_cfg)
    start_step = 0
    if ckpt.committed_steps(job.ckpt_dir):
        (params, opt_state), start_step, _ = ckpt.restore(
            job.ckpt_dir, (params, opt_state))

    step = step_fn or make_train_step(cfg, opt_cfg, remat=True)
    pipe = token_pipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=job.seq_len,
        global_batch=job.global_batch, seed=job.seed))
    # fast-forward the deterministic pipeline to the resume point
    for _ in range(start_step):
        next(pipe)

    history = []
    try:
        for s in range(start_step, job.steps):
            t0 = time.perf_counter()
            batch = stub_inputs(cfg, next(pipe), s, job.global_batch)
            t1 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            loss = float(metrics["loss"])
            rec = {"step": s + 1, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "step_time_s": time.perf_counter() - t1,
                   "data_time_s": t1 - t0}
            history.append(rec)
            if job.log_path:
                with open(job.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if (s + 1) % job.ckpt_every == 0 or (s + 1) == job.steps:
                ckpt.save(job.ckpt_dir, s + 1, (params, opt_state),
                          extra={"loss": loss})
                ckpt.prune(job.ckpt_dir, keep=job.keep_ckpts)
            if fail_at_step is not None and (s + 1) >= fail_at_step:
                raise RuntimeError(f"injected failure at step {s + 1}")
    finally:
        pipe.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return params, opt_state, history
