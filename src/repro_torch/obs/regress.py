"""Benchmark-trajectory regression gate:
``python -m repro_torch.obs.regress`` (a copy of ``repro.obs.regress``).

Every benchmark appends one point per run to its tracked trajectory
(``results/BENCH_<name>.json``, a JSON list). Points that want to be
gated carry a ``regress`` dict of lower-is-better scalars, e.g.::

    {"ts": ..., "regress": {"p50_ms": 1.8, "p99_ms": 4.1}, ...}

This module compares each metric's NEWEST value against the MEDIAN of
its history (all earlier points that carry the metric): a regression is
``newest > median * (1 + tolerance)``. The median makes the baseline
robust to one noisy historical point; the tolerance absorbs normal CI
jitter. Metrics need ``min_history`` historical points before they are
judged — young trajectories report ``insufficient history`` and pass.

Exit status 0 = clean (or nothing to judge), 1 = at least one
regression. CI runs this right after the bench smokes so a perf cliff
fails the build with the offending metric named.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional

DEFAULT_TOLERANCE = 0.35
DEFAULT_MIN_HISTORY = 3


def check_trajectory(points: List[dict], *,
                     tolerance: float = DEFAULT_TOLERANCE,
                     min_history: int = DEFAULT_MIN_HISTORY
                     ) -> List[dict]:
    """Judge the newest point of one trajectory against its history.
    Returns one row per gated metric:
    ``{"metric", "newest", "median", "limit", "n_history", "status"}``
    with status ``ok`` / ``regression`` / ``insufficient_history``."""
    rows: List[dict] = []
    if not points:
        return rows
    newest = points[-1].get("regress") or {}
    for metric, value in sorted(newest.items()):
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue
        history = [float(p["regress"][metric]) for p in points[:-1]
                   if isinstance(p.get("regress"), dict)
                   and metric in p["regress"]]
        if len(history) < min_history:
            rows.append({"metric": metric, "newest": v,
                         "median": None, "limit": None,
                         "n_history": len(history),
                         "status": "insufficient_history"})
            continue
        median = statistics.median(history)
        limit = median * (1.0 + tolerance)
        rows.append({"metric": metric, "newest": v,
                     "median": median, "limit": limit,
                     "n_history": len(history),
                     "status": "regression" if v > limit else "ok"})
    return rows


def load_trajectory(path: Path) -> Optional[List[dict]]:
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return data if isinstance(data, list) else None


def check_dir(results_dir: Path, *,
              tolerance: float = DEFAULT_TOLERANCE,
              min_history: int = DEFAULT_MIN_HISTORY
              ) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for path in sorted(results_dir.glob("BENCH_*.json")):
        points = load_trajectory(path)
        if points is None:
            out[path.name] = [{"metric": None, "status": "unreadable"}]
            continue
        out[path.name] = check_trajectory(
            points, tolerance=tolerance, min_history=min_history)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Gate the newest benchmark trajectory points "
                    "against their history.")
    ap.add_argument("--results-dir", default="results",
                    help="directory holding BENCH_*.json trajectories")
    ap.add_argument("--tolerance", type=float,
                    default=DEFAULT_TOLERANCE,
                    help="allowed fractional slowdown vs the median "
                         "(default %(default)s)")
    ap.add_argument("--min-history", type=int,
                    default=DEFAULT_MIN_HISTORY,
                    help="historical points required before judging "
                         "(default %(default)s)")
    args = ap.parse_args(argv)

    results_dir = Path(args.results_dir)
    if not results_dir.is_dir():
        print(f"regress: no results dir at {results_dir}", flush=True)
        return 0
    report = check_dir(results_dir, tolerance=args.tolerance,
                       min_history=args.min_history)
    if not report:
        print("regress: no trajectories found", flush=True)
        return 0
    failed = False
    for name, rows in report.items():
        if not rows:
            print(f"  {name}: no gated metrics")
            continue
        for r in rows:
            if r["status"] == "unreadable":
                print(f"  {name}: unreadable trajectory (skipped)")
                continue
            if r["status"] == "insufficient_history":
                print(f"  {name}: {r['metric']}={r['newest']:g} "
                      f"(only {r['n_history']} historical points, "
                      f"not judged)")
                continue
            mark = "REGRESSION" if r["status"] == "regression" else "ok"
            print(f"  {name}: {r['metric']}={r['newest']:g} "
                  f"median={r['median']:g} limit={r['limit']:g} "
                  f"[{mark}]")
            failed = failed or r["status"] == "regression"
    print("regress: FAIL" if failed else "regress: ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
