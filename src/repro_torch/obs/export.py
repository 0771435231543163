"""Chrome trace-event export: span trees -> a Perfetto-loadable JSON (a
copy of ``repro.obs.export``: the span format and the trace it writes are
the reference's, so each package's validator reads the other's traces).

Emits the Trace Event Format's JSON-array flavor (``{"traceEvents":
[...]}``) using duration events (``ph: "B"``/``"E"``), which both
``chrome://tracing`` and https://ui.perfetto.dev load directly.

Lane layout: one *process* per host (client, each graph-host endpoint)
and one *thread* per (track, OS-thread) pair within it — pipeline
stations (select / build / pack / device / rpc) each get their own lane,
and splitting by the recording OS thread guarantees the B/E events on
every lane are properly nested (each OS thread opens/closes spans as a
stack; two RPC workers sharing one lane would interleave their B/E
pairs and corrupt the nesting).

``validate_chrome_trace`` checks the invariants the CI smoke gates on:
every ``B`` has a matching same-lane ``E``, stacks close in LIFO order,
timestamps are non-negative and monotone per lane, and the span-level
parent references resolve.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence, Tuple


def _lane_maps(spans: Sequence[dict]
               ) -> Tuple[Dict[str, int], Dict[tuple, int]]:
    """Stable pid per host, tid per (host, track, thread) lane."""
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    for sp in spans:
        host = sp.get("host", "client")
        if host not in pids:
            pids[host] = len(pids) + 1
        lane = (host, sp.get("track") or sp["name"],
                sp.get("args", {}).get("tid", 0))
        if lane not in tids:
            tids[lane] = len(tids) + 1
    return pids, tids


def _span_lane(sp: dict, pids, tids) -> Tuple[int, int, str]:
    host = sp.get("host", "client")
    track = sp.get("track") or sp["name"]
    return (pids[host],
            tids[(host, track, sp.get("args", {}).get("tid", 0))], track)


def to_chrome_trace(spans: Sequence[dict]) -> dict:
    """Span dicts (obs.trace.span_dict shape) -> trace-event JSON tree.

    Timestamps are microseconds relative to the earliest span — Perfetto
    renders relative time anyway and small numbers keep the file compact.
    """
    spans = sorted(spans, key=lambda s: (s["t0"], -s["dur"]))
    pids, tids = _lane_maps(spans)
    t_base = spans[0]["t0"] if spans else 0.0
    events: List[dict] = []
    for host, pid in pids.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": host}})
    for (host, track, _thr), tid in tids.items():
        events.append({"ph": "M", "name": "thread_name",
                       "pid": pids[host], "tid": tid,
                       "args": {"name": track}})
    # Per-lane stack simulation. Spans on one lane come from one OS
    # thread's span stack, so they nest exactly (child window inside
    # parent window) — emitting B when a span starts and E when a later
    # span's start passes an open span's end reconstructs the correct
    # LIFO B/E sequence even for zero-duration and equal-timestamp spans
    # (where a plain global timestamp sort would misorder them).
    by_lane: Dict[tuple, List[dict]] = {}
    for sp in spans:
        by_lane.setdefault(_span_lane(sp, pids, tids), []).append(sp)
    for (pid, tid, _track), lane_spans in sorted(by_lane.items(),
                                                 key=lambda t: t[0][:2]):
        lane_spans.sort(key=lambda s: (s["t0"], -s["dur"]))
        open_stack: List[tuple] = []     # (t_end_us, E-event)
        for sp in lane_spans:
            ts = (sp["t0"] - t_base) * 1e6
            dur = max(sp["dur"], 0.0) * 1e6
            while open_stack and open_stack[-1][0] <= ts:
                events.append(open_stack.pop()[1])
            args = {k: v for k, v in sp.get("args", {}).items()
                    if k != "tid"}
            args["trace_id"] = sp["trace_id"]
            args["span_id"] = sp["span_id"]
            if sp.get("parent_id") is not None:
                args["parent_id"] = sp["parent_id"]
            base = {"name": sp["name"], "cat": sp.get("cat", "stage"),
                    "pid": pid, "tid": tid}
            events.append(dict(base, ph="B", ts=ts, args=args))
            # clamp into the parent window: nested recording guarantees
            # containment on live spans; the clamp keeps stitched remote
            # spans (shifted by an *estimated* clock offset) well-formed
            t_end = ts + dur
            if open_stack:
                t_end = min(t_end, open_stack[-1][0])
            open_stack.append((max(t_end, ts),
                               dict(base, ph="E", ts=max(t_end, ts))))
        while open_stack:
            events.append(open_stack.pop()[1])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Sequence[dict],
                       metadata: dict = None) -> dict:
    tree = to_chrome_trace(spans)
    if metadata:
        tree["metadata"] = metadata
    with open(path, "w") as f:
        json.dump(tree, f, separators=(",", ":"))
    return tree


def validate_chrome_trace(tree: dict) -> List[str]:
    """Shape invariants of an exported trace; returns a list of problems
    (empty = valid). This is what the CI bench smoke gates on."""
    problems: List[str] = []
    events = tree.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[tuple, list] = {}
    last_ts: Dict[tuple, float] = {}
    span_ids = set()
    parent_refs = []
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph not in ("B", "E"):
            problems.append(f"event {i}: unexpected ph={ph!r}")
            continue
        lane = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ts < last_ts.get(lane, 0.0) - 1e-6:
            problems.append(
                f"event {i}: ts went backwards on lane {lane}")
        last_ts[lane] = ts
        stack = stacks.setdefault(lane, [])
        if ph == "B":
            stack.append(ev.get("name"))
            args = ev.get("args", {})
            if "span_id" in args:
                span_ids.add(args["span_id"])
            if args.get("parent_id") is not None:
                parent_refs.append((i, args["parent_id"]))
        else:
            if not stack:
                problems.append(
                    f"event {i}: E with no open B on lane {lane}")
            elif stack[-1] != ev.get("name"):
                problems.append(
                    f"event {i}: E {ev.get('name')!r} closes "
                    f"{stack[-1]!r} (non-LIFO) on lane {lane}")
                stack.pop()
            else:
                stack.pop()
    for lane, stack in stacks.items():
        for name in stack:
            problems.append(f"unclosed B {name!r} on lane {lane}")
    for i, pid in parent_refs:
        if pid not in span_ids:
            problems.append(
                f"event {i}: parent_id {pid} resolves to no span")
    return problems


def containment(spans: Sequence[dict], outer_name: str,
                inner_host: str, slack_s: float = 0.0) -> List[str]:
    """Check that every remote span from ``inner_host`` lies inside its
    batch's ``outer_name`` span window (the clock-offset acceptance
    gate). Returns violations (empty = all contained)."""
    outer: Dict[int, Tuple[float, float]] = {}
    for sp in spans:
        if sp["name"] == outer_name:
            t0, t1 = sp["t0"], sp["t0"] + sp["dur"]
            if sp["trace_id"] in outer:
                o0, o1 = outer[sp["trace_id"]]
                t0, t1 = min(t0, o0), max(t1, o1)
            outer[sp["trace_id"]] = (t0, t1)
    bad = []
    for sp in spans:
        if sp.get("host") != inner_host:
            continue
        win = outer.get(sp["trace_id"])
        if win is None:
            bad.append(f"remote span {sp['name']} trace {sp['trace_id']}"
                       f" has no {outer_name} span")
            continue
        t0, t1 = sp["t0"], sp["t0"] + sp["dur"]
        if t0 < win[0] - slack_s or t1 > win[1] + slack_s:
            bad.append(
                f"remote span {sp['name']} [{t0:.6f},{t1:.6f}] outside "
                f"{outer_name} [{win[0]:.6f},{win[1]:.6f}] "
                f"(trace {sp['trace_id']})")
    return bad


def main(argv=None) -> int:
    """``python -m repro_torch.obs.export``: convert a span-dump JSON (list of
    span dicts, e.g. a flight-recorder entry) to a chrome trace, or
    validate an already-exported trace."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Span dump -> Perfetto-loadable chrome trace "
                    "(or validate one)")
    ap.add_argument("input", help="JSON file: a list of span dicts, or "
                    "a chrome trace when --validate is given")
    ap.add_argument("-o", "--out", default=None,
                    help="output trace path (default: <input>.trace.json)")
    ap.add_argument("--validate", action="store_true",
                    help="treat input as a chrome trace and validate it")
    args = ap.parse_args(argv)
    with open(args.input) as f:
        tree = json.load(f)
    if args.validate:
        problems = validate_chrome_trace(tree)
        for p in problems:
            print(f"INVALID: {p}")
        print(f"{args.input}: "
              f"{'OK' if not problems else f'{len(problems)} problems'}")
        return 1 if problems else 0
    spans = tree if isinstance(tree, list) else tree.get("spans", [])
    out = args.out or args.input.rsplit(".json", 1)[0] + ".trace.json"
    exported = write_chrome_trace(out, spans)
    problems = validate_chrome_trace(exported)
    n = sum(1 for e in exported["traceEvents"] if e.get("ph") == "B")
    print(f"wrote {out}: {n} spans "
          f"({'valid' if not problems else problems})")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["to_chrome_trace", "write_chrome_trace",
           "validate_chrome_trace", "containment", "main"]
