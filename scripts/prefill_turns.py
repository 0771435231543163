#!/usr/bin/env python3
"""Card probe: one model's prefill through an earlier commit's port and
this tree's, in turns.

    python3 scripts/prefill_turns.py --extract [--rev HEAD~1]   # in git
    python3 scripts/prefill_turns.py [--arch whisper|phi3|pixtral|jamba]
        [--order parent,this,this,parent]

``--extract`` writes the earlier commit's ``src/repro_torch`` (``git
archive``) to ``build/prefill_parent/`` (which ``.gitignore`` covers) with
the revision's hash beside it, and exits; the machine with the card need
not hold the repository's history. Without it, the probe runs one process a
turn, in the order given, each importing the port of one tree (``parent``:
that copy, ``this``: this tree), building its kernels into that tree's own
build directory, and serving one model as ``chip_smoke.py``'s ``[lm]``
phases do (random weights from seed 0, impl="cuda"): whisper-tiny at full
width and depth (16 clips of 1500 frames and a 448-token prompt), or one
8192-token prompt through phi3-medium-14b (8 of 40 layers), pixtral-12b (8
of 40 layers, 256 random patch embeddings spliced) or one period of
jamba-1.5-large-398b (8 layers, experts 16 -> 4), each at full width, the
inputs from seed 0: two warm-up prefills, ``--prefills`` timed ones (host
wall clock around a synchronised call), then one traced by
``torch.profiler`` for the device time (all kernels, and the flash
kernels' own). Each turn must launch the model's flash kernels a prefill
(8, 8, 8, 1), all on the wgmma kernel. Prints one line a turn and the
median of each tree's turns; exits 1 when a turn fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = ROOT / "build" / "prefill_parent"
# --arch: (registry name, batch, prompt length, flash launches a prefill)
ARCHS = {"whisper": ("whisper-tiny", 16, 448, 8),
         "phi3": ("phi3-medium-14b", 1, 8192, 8),
         "pixtral": ("pixtral-12b", 1, 8192, 8),
         "jamba": ("jamba-1.5-large-398b", 1, 8192, 1)}


def extract(rev: str) -> None:
    PARENT.mkdir(parents=True, exist_ok=True)
    tar = subprocess.run(["git", "archive", rev, "src/repro_torch"],
                         cwd=ROOT, check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", str(PARENT)], input=tar, check=True)
    sha = subprocess.run(["git", "rev-parse", rev], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    (PARENT / "REV").write_text(sha + "\n")
    print(f"extracted src/repro_torch of {sha} to {PARENT}")


def model(arch: str):
    """(config, params, batch) of ``arch`` as chip_smoke.py serves it."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    name, B, seq, _ = ARCHS[arch]
    full = get_config(name)
    if arch in ("phi3", "pixtral"):
        cfg = dataclasses.replace(full, n_layers=8)
    elif arch == "jamba":
        cfg = dataclasses.replace(
            full, n_layers=full.hybrid_attn_period,
            moe=dataclasses.replace(full.moe, num_experts=4))
    else:
        cfg = full
    params = transformer.init_params(
        cfg, seed=0, device="cuda",
        **({"max_seq": seq} if arch == "whisper" else {}))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    if arch == "whisper":
        frames = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames).cuda()
    elif arch == "pixtral":
        patches = rng.standard_normal(
            (B, cfg.vision.n_patches, cfg.d_model)).astype(np.float32)
        batch["patch_embeds"] = torch.from_numpy(patches).cuda()
    return cfg, params, batch


def turn(tree: Path, arch: str, prefills: int) -> dict:
    """One tree's prefills, in this process."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as flash_kernels
    from repro_torch.models import transformer
    assert Path(transformer.__file__).is_relative_to(tree)
    build.build()
    cfg, params, batch = model(arch)

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transformer.prefill(cfg, params, batch, impl="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prefill()
    prefill()
    ops.reset_launch_counts()
    times = [prefill() for _ in range(prefills)]
    flash = ops.launch_counts()["flash_attention"] // prefills
    wgmma = flash_kernels.variant_launches["wgmma"] // prefills
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = prefill()
    dev = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    return dict(wall_ms=times, p50_ms=statistics.median(times),
                traced_wall_ms=wall,
                device_ms=sum(us for _, us in dev) / 1e3,
                flash_device_ms=sum(us for k, us in dev
                                    if "flash" in k.lower()) / 1e3,
                flash=flash, wgmma=wgmma)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--extract", action="store_true")
    ap.add_argument("--rev", default="HEAD~1")
    ap.add_argument("--arch", default="whisper", choices=list(ARCHS))
    ap.add_argument("--order", default="parent,this,this,parent")
    ap.add_argument("--prefills", type=int, default=9)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.extract:
        extract(args.rev)
        return 0
    if args.turn:
        print(json.dumps(turn(Path(args.turn), args.arch, args.prefills)),
              flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    trees = {"parent": PARENT, "this": ROOT}
    rev = (PARENT / "REV").read_text().strip() if (PARENT / "REV").exists() \
        else None
    if rev is None:
        print("prefill_turns: run --extract first", file=sys.stderr)
        return 1
    arch, B, seq, n_flash = ARCHS[args.arch]
    print(f"[env] {card}; parent {rev}", flush=True)
    got = {}
    for i, name in enumerate(args.order.split(",")):
        run = subprocess.run([sys.executable, __file__, "--turn",
                              str(trees[name]), "--arch", args.arch,
                              "--prefills", str(args.prefills)],
                             capture_output=True, text=True)
        if run.returncode:
            print(f"prefill_turns: turn {i} ({name}) failed:\n"
                  f"{run.stderr[-3000:]}", file=sys.stderr)
            return 1
        r = json.loads(run.stdout.strip().splitlines()[-1])
        ok = r["flash"] == n_flash and r["wgmma"] == n_flash
        got.setdefault(name, []).append(r)
        print(f"[turn {i}] {name}: {arch} prefill B={B} S={seq} wall "
              f"{', '.join(f'{t:.3f}' for t in r['wall_ms'])} ms (p50 "
              f"{r['p50_ms']:.3f}); traced {r['traced_wall_ms']:.3f} ms wall, "
              f"device {r['device_ms']:.3f} ms, flash kernels "
              f"{r['flash_device_ms']:.3f} ms; flash launches {r['flash']} "
              f"a prefill ({r['wgmma']} wgmma) {'ok' if ok else 'FAIL'} "
              f"[{card}]", flush=True)
        if not ok:
            return 1
    for name, rs in got.items():
        print(f"[summary] {name}: p50 wall by turn "
              f"{[round(r['p50_ms'], 3) for r in rs]} ms, device "
              f"{[round(r['device_ms'], 3) for r in rs]} ms, flash kernels "
              f"{[round(r['flash_device_ms'], 3) for r in rs]} ms [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
