#!/usr/bin/env python3
"""Whether LM training lowers the loss under each cross-entropy gradient
rule, on the CPU: the reference's trainer, and the PyTorch package's with
its own ``softmax_xent`` and with the reference's rule put back.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/xent_probe.py \
        [--arch whisper-tiny] [--steps 30] [--seq-len 128] [--batch 4]

The full config of ``--arch`` (whisper-tiny: 0.059 B parameters, its 1500
frames a clip) trained from each package's seed-0 weights on the
deterministic token pipeline, AdamW at lr 1e-3, no checkpoint. The
reference's ``softmax_xent`` stops the gradient inside the shifted
exponentials only, so its gradient is softmax - onehot(label) + onehot(
argmax); the port's takes the max out of the graph (softmax -
onehot(label)). Prints each run's losses and the mean of its first and
last five. It checks nothing; it needs jax and the reference package
besides torch.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro.configs.registry import get_config as j_get_config
from repro.train import loop as j_loop
from repro.train.optim import AdamWConfig as JAdamW
from repro_torch.configs.registry import get_config
from repro_torch.train import loop, step
from repro_torch.train.optim import AdamWConfig


def _reference_rule(logits, labels, mask=None):
    """The reference's gradient rule in torch: the max is detached inside
    the exponentials only."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lg - m.detach()).sum(dim=-1)) + m[..., 0]
    labels = torch.as_tensor(labels, device=lg.device).long()
    per_tok = lse - lg.gather(-1, labels[..., None])[..., 0]
    return per_tok.mean(), per_tok


def _report(what, hist):
    losses = [h["loss"] for h in hist]
    print(f"{what}: first 5 {np.mean(losses[:5]):.4f}, last 5 "
          f"{np.mean(losses[-5:]):.4f}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    job = dict(steps=args.steps, ckpt_every=10 ** 9, seq_len=args.seq_len,
               global_batch=args.batch)
    print(f"{args.arch} (full config), {args.steps} steps of "
          f"{args.batch} x {args.seq_len} tokens, lr 1e-3, CPU", flush=True)
    with tempfile.TemporaryDirectory() as d:
        _, _, hist = j_loop.train(
            j_get_config(args.arch),
            j_loop.TrainJobConfig(ckpt_dir=f"{d}/ref", **job),
            JAdamW(lr=1e-3))
        _report("reference (its rule)", hist)
        cfg = get_config(args.arch)
        _, _, hist = loop.train(cfg, loop.TrainJobConfig(
            ckpt_dir=f"{d}/port", **job), AdamWConfig(lr=1e-3),
            device="cpu")
        _report("port (max out of the graph)", hist)
        real = step.softmax_xent
        step.softmax_xent = _reference_rule
        try:
            _, _, hist = loop.train(cfg, loop.TrainJobConfig(
                ckpt_dir=f"{d}/rule", **job), AdamWConfig(lr=1e-3),
                device="cpu")
        finally:
            step.softmax_xent = real
        _report("port with the reference's rule", hist)


if __name__ == "__main__":
    main()
