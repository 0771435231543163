#!/usr/bin/env python3
"""What the program's tracer costs the host, operation by operation, and
what its device marks cost a traced batch at the benchmark cells' depth.

    python3 scripts/tracer_cost.py [--layers 16] [--reps 20000]

Prints one JSON line, in microseconds of host time: ``span_us`` (open and
close one span), ``record_span_us`` (one span recorded after the fact),
``totals_us`` (one ``Tracer.totals()`` read over the probe's names), and
on a card ``event_record_us`` (one CUDA timing event), ``anchor_us`` (one
``anchor_gpu``) and ``marks_and_resolve_us_gcn`` / ``_gat``: the median
over 200 device spans of recording a batch's marks (begin, input, each
layer, tail; GAT also its attention steps) and resolving them into
``gpu.*`` spans once the card has reached them. A traced batch costs
about its spans (``spans_per_batch`` in ``scripts/trace_turns.py``'s "on"
lines) times ``span_us``, plus its marks. The card's name and power limit
come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.obs import TraceConfig, Tracer  # noqa: E402
from repro_torch.obs.trace import now  # noqa: E402


def per_us(fn, n: int) -> float:
    """Mean microseconds of ``fn()`` over ``n`` calls."""
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t) / n


def marks_us(tr: Tracer, dev, marks: list) -> float:
    """Median host microseconds of recording ``marks`` on a device span
    and resolving them when it closes (the wait for the card excluded)."""
    costs = []
    for _ in range(200):
        ctx = tr.maybe_trace()
        h = tr.open_span("device", ctx=ctx)
        with tr.activate(h):
            mark = tr.gpu_marker(dev)
            t0 = time.perf_counter()
            for label in marks:
                mark(label)
            t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tr.close_span(h)
        t3 = time.perf_counter()
        tr.finish_ticket(ctx)
        costs.append(1e6 * (t1 - t0 + t3 - t2))
    costs.sort()
    return costs[len(costs) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20000)
    args = ap.parse_args(argv)
    on_card = torch.cuda.is_available()
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    tr = Tracer(TraceConfig(ring_capacity=1 << 18))
    out = {}
    ctx = tr.maybe_trace()

    def span():
        with tr.span("x", ctx=ctx):
            pass
    out["span_us"] = per_us(span, args.reps)

    def record():
        t = now()
        tr.record_span("y", ctx, t, t)
    out["record_span_us"] = per_us(record, args.reps)
    tr.finish_ticket(ctx)
    out["totals_us"] = per_us(tr.totals, 1000)
    if on_card:
        dev = torch.device("cuda")
        torch.ones(1, device=dev)
        torch.cuda.synchronize()
        tr.anchor_gpu(dev)
        stream = torch.cuda.current_stream(dev)
        out["event_record_us"] = per_us(
            lambda: torch.cuda.Event(enable_timing=True).record(stream),
            args.reps)
        torch.cuda.synchronize()
        out["anchor_us"] = per_us(tr.anchor_gpu, 200)
        step = ["layer"] * args.layers
        attn = ["attention.begin", "attention.end", "layer"] * args.layers
        for name, body in (("gcn", step), ("gat", attn)):
            out[f"marks_and_resolve_us_{name}"] = marks_us(
                tr, dev, ["begin", "input", *body, "tail"])
    out["spans_dropped"] = tr.spans_dropped
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
