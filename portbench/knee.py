"""The knee of a cell's deployment: the highest Poisson rate it
sustains, found by a sweep on the card, for an open-loop cell's rate.

    python3 portbench/knee.py --workload gcn-l16-c512-zipf-closed \
        --seed 7 --rates 1000,1500,2000 --seconds 30

One set-up of the cell's configuration and working set, then one window a
rate of open-loop Poisson arrivals over the cell's mix, lowest first,
each drained before the next. A rate is sustained when its queue does not grow through the
window: the median latency of the requests due in its last third is
under 1.25 times that of those due in its first third. One JSON line a
rate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402

from portbench import load, run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    graph, ranked, params, system = run.deploy(cfg, traffic, args.seed,
                                               "cuda", cfg["impl"])
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix = dict(traffic, loop="open", rate_per_s=rate)
            targets, due = load.plan(mix, ranked, args.seed + i,
                                     args.seconds)
            before = system.counters()
            w = load.run(system.submit, mix, targets, due, args.seconds,
                       system.answered)
            after = system.counters()
            lat = np.array([s.latency_s if s.t_seen else np.inf
                            for s in w.sent])
            due_at = np.array([s.t_due - w.t0 for s in w.sent])
            first = np.median(lat[due_at < args.seconds / 3])
            last = np.median(lat[due_at >= 2 * args.seconds / 3])
            came = len(w.answered_in_window())
            ok = last < 1.25 * first
            batches = after["lane_batches"] - before["lane_batches"]
            print(json.dumps({
                "rate_per_s": rate, "due": len(w.sent),
                "answered_per_s": came / w.seconds,
                "p50_first_third_ms": first * 1e3,
                "p50_last_third_ms": last * 1e3, "sustained": bool(ok),
                "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                "p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "fill_pct": 100.0 * (after["served"] - before["served"])
                / max(1, batches * cfg["batch_size"]),
                "late_max_ms": 1e3 * max(s.t_sent - s.t_due
                                         for s in w.sent)}), flush=True)
    finally:
        system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
