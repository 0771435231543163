#!/usr/bin/env python3
"""Card probe: what the program's tracer costs a benchmark cell, and
whether its spans hold together there.

    python3 scripts/trace_turns.py --workload gcn-l16-c512-zipf-closed \
        --seeds 3100000001,3100000002 --seconds 51 [--turns off,on,on,off]

Runs the cell with ``portbench/run.py``'s ``run_cell`` and ``--trace 1``
(the profiler on every turn), once a turn, in one process: "on" as the
benchmark runs it (``portbench/progtrace.py`` attaches the program's
tracer as the window opens), "off" with the tracer never attached. Turn i
takes seed i // 2 of ``--seeds``, so turns one and two share a seed, and
three and four. Each turn prints one JSON line: ``correct``, ``emb_gap``,
``served_targets_per_s``, ``host_stages_ms``, ``kernel_ms_per_batch``,
whether every request of a target got the same bits (``repeats_equal``),
and, on a turn whose seed the turn before had, how many of the targets
both served got the same bits in both (``same_bits``: a seed gives the
same graph and weights, so traced and untraced answers are compared
bitwise). On "on" turns also the new per-layer metrics, the device's idle
seconds by the awaited batch's station, and the checks of the spans:
Select + Build + Pack over ``host_stages_ms``,
``device_layers_ms_per_batch`` over ``kernel_ms_per_batch``, spans
dropped, how far any ``gpu.*`` span lies outside its batch's ``device``
span, beside the anchor's round trip, the median of a few spans, the
spans a traced batch records (``spans_per_batch``: times
``scripts/tracer_cost.py``'s ``span_us``, the tracer's host cost a batch)
and each station's self milliseconds a batch (``self_ms``, from
``Tracer.totals``: Pack's is its time outside ``pack.assemble``,
``pack.device_batch`` and ``pack.payload``; the device span's, outside
``h2d.stage``). The card's name and power limit come first. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from portbench import progtrace, run  # noqa: E402

NEW = ("queue_wait_ms", "select_ms_per_batch", "build_ms_per_batch",
       "pack_ms_per_batch", "device_layers_ms_per_batch",
       "attention_ms_per_batch", "idle_awaiting_build_pct", "kernel_build_s")


def outside_s(spans) -> float:
    """The most any gpu.* span lies outside its batch's device span (0 if
    all lie inside)."""
    dev = {s["span_id"]: s for s in spans if s["name"] == "device"}
    worst = 0.0
    for s in spans:
        d = dev.get(s["parent_id"]) if s["name"].startswith("gpu.") \
            else None
        if d is None:
            continue
        worst = max(worst, d["t0"] - s["t0"],
                    (s["t0"] + s["dur"]) - (d["t0"] + d["dur"]))
    return worst


def answers(window) -> tuple:
    """({target: its first answer's bytes}, whether every later answer of
    each target had the same bytes)."""
    first, same = {}, True
    for s in window.sent:
        emb = getattr(s.req, "embedding", None)
        if emb is None:
            continue
        b = np.asarray(emb).tobytes()
        same &= first.setdefault(s.target, b) == b
    return first, same


def turn(workload: str, seed: int, seconds: float, on: bool,
         before: dict = None) -> dict:
    """One turn's line; ``before``: the answers of the turn before on the
    same seed, compared bitwise on the targets both served."""
    kept = {}
    real = progtrace.snapshot

    def snapshot(system):
        if not on:
            return None
        got = kept["last"] = real(system)
        kept.setdefault("first", got)
        return got
    progtrace.snapshot = snapshot     # the readers bind it as they load

    def also(window, *_):
        kept["answers"], kept["repeats_equal"] = answers(window)

    rec = {}
    real_read = progtrace.idle_by_station

    def idle_by_station(r, name):
        rec["idle"] = real_read(r, name)
        return rec["idle"]
    progtrace.idle_by_station = idle_by_station
    try:
        result, _, _ = run.run_cell(workload, seed, seconds, True,
                                    also=also)
    finally:
        progtrace.snapshot = real
        progtrace.idle_by_station = real_read
    m = {k: v["value"] for k, v in result["metrics"].items()}
    line = {"workload": workload, "seed": seed, "tracer": on,
            "correct": result["correct"],
            "emb_gap": result["checks"]["emb_gap"]["value"],
            **{k: m.get(k) for k in ("served_targets_per_s",
                                     "host_stages_ms",
                                     "kernel_ms_per_batch")},
            "repeats_equal": kept["repeats_equal"]}
    if before is not None:
        common = kept["answers"].keys() & before.keys()
        line["same_bits"] = {"common": len(common), "equal": sum(
            kept["answers"][t] == before[t] for t in common)}
    line["_answers"] = kept["answers"]
    if on:
        r, r0 = kept["last"], kept["first"]
        line.update({k: m.get(k) for k in NEW})
        stages = [m.get(k) for k in NEW[1:4]]
        if None not in stages and m.get("host_stages_ms"):
            line["stages_over_host_stages"] = \
                sum(stages) / m["host_stages_ms"]
        if m.get("device_layers_ms_per_batch") and \
                m.get("kernel_ms_per_batch"):
            line["layers_over_kernels"] = \
                m["device_layers_ms_per_batch"] / m["kernel_ms_per_batch"]
        line["median_ms"] = {
            name: 1e3 * statistics.median(durs) if durs else None
            for name in ("batch", "device", "dispatch.wait_host",
                         "lane.form", "lane.admit")
            for durs in [[s["dur"] for s in r["spans"]
                          if s["name"] == name]]}
        roots = sum(s["name"] == "batch" for s in r["spans"])
        line["spans_per_batch"] = len(r["spans"]) / roots if roots else None
        line["self_ms"] = {}
        for name in ("select", "build", "pack", "device"):
            n0, _, own0 = r0["totals"].get(name, (0, 0.0, 0.0))
            n1, _, own1 = r["totals"].get(name, (0, 0.0, 0.0))
            line["self_ms"][name] = 1e3 * (own1 - own0) / (n1 - n0) \
                if n1 > n0 else None
        line.update(idle_s_by_station=rec.get("idle"),
                    dropped=r["dropped"],
                    traced_batches=roots,
                    gpu_outside_us=1e6 * outside_s(r["spans"]),
                    gpu_anchor_rtt_us=r["gpu_anchor_rtt_us"])
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--turns", default="off,on,on,off")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    last_seed, last = None, None
    for i, mode in enumerate(args.turns.split(",")):
        seed = seeds[min(i // 2, len(seeds) - 1)]
        line = turn(args.workload, seed, args.seconds, mode == "on",
                    last if seed == last_seed else None)
        last_seed, last = seed, line.pop("_answers")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
