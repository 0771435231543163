"""Training launcher, the PyTorch counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --reduced --steps 100 --ckpt-dir build/lm_ckpt [--device cpu]

Runs (or resumes, from the latest checkpoint in ``--ckpt-dir``) LM
training on the card, or on the CPU with ``--device cpu``, and prints the
reference's JSON summary (first loss, last loss, steps).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.registry import get_config
from repro_torch.train.loop import TrainJobConfig, train
from repro_torch.train.optim import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=TrainJobConfig().ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    job = TrainJobConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_path=args.log,
                         seq_len=args.seq_len,
                         global_batch=args.global_batch)
    _, _, hist = train(cfg, job, AdamWConfig(lr=args.lr),
                       device=args.device)
    print(json.dumps({"first_loss": hist[0]["loss"],
                      "last_loss": hist[-1]["loss"],
                      "steps": len(hist)}, indent=1))


if __name__ == "__main__":
    main()
