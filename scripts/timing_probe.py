#!/usr/bin/env python3
"""Card probe: why one reading of a kernel's time through the host and one
in a CUDA graph can disagree by 10 %.

    python3 scripts/timing_probe.py [--out chiprun_out/timing_probe.csv]

At whisper's encoder shape (B=16, H=6, S=1500, D=64, non-causal) and
pixtral's (B=1, H=32, 8 KV heads, S=8192, D=128, causal) it times
``flash_attention`` and ``scaled_dot_product_attention`` on the same bf16
inputs four ways, each after two states of the card:

- ``host20``: 20 back-to-back calls between two CUDA events (one
  reading of ``chip_smoke.py``'s ``cuda_ms``);
- ``host500``: 500 back-to-back calls;
- ``graph``: a CUDA graph of 20 calls replayed 10 times;
- ``graph100``: the same graph replayed 100 times;

and the states: ``idle`` (0.5 s with nothing queued first) and ``hot``
(0.3 s of pixtral's kernel first). Meanwhile ``nvidia-smi`` samples the
card's SM clock, power and temperature every 20 ms (``--loop-ms``); each
reading is printed with the mean SM clock and power of the samples taken
while it ran, and every sample goes to ``--out``. Three rounds. Exits 1
when a kernel launch or the sampler fails.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

SHAPES = (  # what, B, H, Kh, S, D, causal
    ("whisper encoder", 16, 6, 6, 1500, 64, False),
    ("pixtral", 1, 32, 8, 8192, 128, True),
)
FIELDS = "timestamp,clocks.sm,power.draw,temperature.gpu"


def events_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def captured(fn, calls=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def samples(path):
    """[(unix seconds, SM MHz, W, deg C)] from the sampler's CSV."""
    out = []
    for line in path.read_text().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 4:
            continue
        try:
            t = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
            out.append((t.timestamp(), float(parts[1].split()[0]),
                        float(parts[2].split()[0]), float(parts[3])))
        except ValueError:
            continue
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "timing_probe.csv"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("timing_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[env] {card}; torch {torch.__version__}", flush=True)
    build.load("flash_attention")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    fns, graphs = {}, {}
    for what, B, H, KH, S, D, causal in SHAPES:
        q, k, v = rnd(B, H, S, D), rnd(B, KH, S, D), rnd(B, KH, S, D)
        fns[what, "kernel"] = (lambda q=q, k=k, v=v, c=causal:
                               flash_attention(q, k, v, causal=c))
        fns[what, "sdpa"] = (lambda q=q, k=k, v=v, c=causal, g=KH < H:
                             F.scaled_dot_product_attention(
                                 q, k, v, is_causal=c, enable_gqa=g))
    for key, fn in fns.items():
        graphs[key] = captured(fn)
    torch.cuda.synchronize()
    burn = fns["pixtral", "kernel"]

    def state(name):
        if name == "idle":
            time.sleep(0.5)
        else:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.3:
                burn()
                torch.cuda.synchronize()

    ways = {"host20": lambda key: events_ms(fns[key], 20),
            "host500": lambda key: events_ms(fns[key], 500),
            "graph": lambda key: events_ms(graphs[key].replay, 10) / 20,
            "graph100": lambda key: events_ms(graphs[key].replay, 100) / 20}
    sampler = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={FIELDS}", "--format=csv,noheader",
         "--loop-ms=20"], stdout=out.open("w"), stderr=subprocess.PIPE)
    readings = []
    try:
        time.sleep(1.0)
        if sampler.poll() is not None:
            print(f"timing_probe: nvidia-smi sampler ended: "
                  f"{sampler.stderr.read().decode()[:300]}", file=sys.stderr)
            return 1
        for r in range(args.rounds):
            for key in fns:
                for st in ("idle", "hot"):
                    for way, timer in ways.items():
                        state(st)
                        for _ in range(2):      # warm-up outside the window
                            fns[key]()
                        torch.cuda.synchronize()
                        t0 = time.time()
                        ms = timer(key)
                        readings.append((r, key, st, way, ms, t0,
                                         time.time()))
        time.sleep(0.2)
    finally:
        sampler.terminate()
        sampler.wait(timeout=10)
    got = samples(out)
    print(f"[probe] {len(got)} sampler readings in {out.name}", flush=True)
    rows = {}
    for r, key, st, way, ms, t0, t1 in readings:
        inside = [s for s in got if t0 <= s[0] <= t1]
        mhz = statistics.mean(s[1] for s in inside) if inside else float("nan")
        watts = statistics.mean(s[2] for s in inside) if inside \
            else float("nan")
        rows.setdefault((key, st, way), []).append((ms, mhz))
        print(f"[probe] round {r} {key[0]} {key[1]} {st} {way}: {ms:.4f} ms, "
              f"{len(inside)} samples, SM {mhz:.0f} MHz, {watts:.0f} W, "
              f"window {(t1 - t0) * 1e3:.1f} ms [{card}]", flush=True)
    for (key, st, way), xs in rows.items():
        ms = [x[0] for x in xs]
        print(f"[summary] {key[0]} {key[1]} {st} {way}: median "
              f"{statistics.median(ms):.4f} ms [{min(ms):.4f}-{max(ms):.4f}]"
              f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
