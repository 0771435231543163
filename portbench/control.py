"""The comparison's readings on the card, for setting a cell's limits.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window at the cell's own load, the checks), and beside the program's
``emb_gap`` the control's: the plain reference computed in TF32 (the
precision below the configuration's fp32) put in the program's place, on
the same sample of targets, against the reference in fp32. One JSON line
a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import check, reference, run  # noqa: E402


def control_gap(window, graph, cfg, params, device, seed) -> float:
    """The TF32 reference's emb_gap on the run's own sample."""
    served = [s.target for s in window.sent if s.req.embedding is not None]
    sample = check.sample_targets(served, cfg["check"]["sample_targets"],
                                  seed)
    subgraphs = reference.build(graph, cfg, sample)
    want = reference.embed(graph, cfg, params, subgraphs, device)
    got = reference.embed(graph, cfg, params, subgraphs, device, tf32=True)
    return float(check.row_gaps(got, want).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = {}

        def also(window, graph, cfg, params, device, seed):
            got["control_gap"] = control_gap(window, graph, cfg, params,
                                             device, seed)

        result, info, checks = run.run_cell(args.workload, seed,
                                            args.seconds, False, also=also)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          **{c.name: c.value for c in checks}, **got,
                          "metrics": {k: v["value"] for k, v
                                      in result["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
