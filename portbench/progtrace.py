"""The program's own tracer, read by the per-layer metrics of a traced run.

``snapshot(system)`` is every such metric's ``snapshot``: at the window's
open it attaches the port's tracer to the running engine
(``DecoupledEngine.attach_tracer``, a ring of ``RING`` spans), so every
batch submitted from then on is traced from inside the program; at the
open and at the close it reads the tracer's exact totals by span name, its
dropped-span count, its finished spans, the server's queue-wait counters
and the kernel builds. The run calls each metric's ``snapshot`` back to
back, once as the window opens and once as it closes, so the tracer is
read once at each end and every metric gets that reading: the open one
until the server has admitted a request since (no traffic runs at the
open), then the close one. Where the program has no such tracer or
counter (an older program), the reading is None and the metrics read
nothing.

Only ``--trace 1`` runs read per-layer metrics, so the untraced runs
never attach the tracer.
"""
from __future__ import annotations

import bisect
import weakref
from typing import Dict, List, Optional, Tuple

RING = 1 << 18          # spans kept: ~50 a batch, ~50 batches a window

# system -> [open reading, close reading or None]
_readings: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def snapshot(system) -> Optional[dict]:
    """The program's tracer and counters as one reading (see the module
    docstring), or None where the program lacks them."""
    eng = system.engine
    stats = system.server.stats
    if not hasattr(eng, "attach_tracer") or not hasattr(stats,
                                                        "queue_wait_s"):
        return None
    got = _readings.get(system)
    if got is not None:
        opened, closed = got
        if closed is not None:
            return closed
        if opened["n_admitted"] == stats.n_admitted:
            return opened
    from repro_torch.kernels import build
    from repro_torch.obs.trace import TraceConfig
    tracer = eng.attach_tracer(TraceConfig(ring_capacity=RING))
    reading = {"totals": tracer.totals(), "dropped": tracer.spans_dropped,
               "spans": tracer.export_spans(),
               "queue_wait_s": stats.queue_wait_s,
               "n_admitted": stats.n_admitted, "build": build.stats(),
               "gpu_anchor_rtt_us": tracer.gpu_anchor_rtt_us}
    if got is None:
        _readings[system] = [reading, None]
    else:
        got[1] = reading
    return reading


def readings(rec, name: str) -> Optional[Tuple[dict, dict]]:
    """(open, close) readings of the metric ``name``; None where the
    program gave none or its tracer dropped a span."""
    a, b = rec.before.get(name), rec.after.get(name)
    if a is None or b is None or b["dropped"]:
        return None
    return a, b


def total_delta(a: dict, b: dict, span: str) -> Tuple[int, float]:
    """(count, seconds) of the spans named ``span`` closed in the
    window."""
    n0, s0, _ = a["totals"].get(span, (0, 0.0, 0.0))
    n1, s1, _ = b["totals"].get(span, (0, 0.0, 0.0))
    return n1 - n0, s1 - s0


def mean_ms(rec, name: str, span: str) -> Optional[float]:
    """Milliseconds a traced batch that finished in the window spent in
    the spans named ``span``: their seconds over the count of those
    batches (their ``batch`` roots). The spans are the close reading's
    finished trees less the open reading's, so batches still in flight at
    the close count in neither sum, as in the scheduler's per-batch stage
    times."""
    got = readings(rec, name)
    if got is None:
        return None
    a, b = got
    before = {sp["trace_id"] for sp in a["spans"]}
    roots = {sp["trace_id"] for sp in b["spans"]
             if sp["name"] == "batch" and sp["trace_id"] not in before}
    s = sum(sp["dur"] for sp in b["spans"]
            if sp["name"] == span and sp["trace_id"] in roots)
    return 1e3 * s / len(roots) if roots else None


# -- the device's idle time by the station of the batch it waited for --------

STATIONS = ("select", "build", "pack")


def idle_by_station(rec, name: str) -> Optional[Dict[str, float]]:
    """Idle seconds of the device, from the start of the window's first
    traced ``dispatch.wait_host`` span to the end of its last, split by
    where the batch the dispatcher was waiting for stood: in Select or
    queued for it ("select"), queued for Build or in it ("build"), queued
    for Pack or in it ("pack"); idle outside every wait goes to "other".
    Spans are mapped onto the profiler's clock by the port's
    ``perf_counter_of`` minus the window's start. None without spans or a
    device trace."""
    got = readings(rec, name)
    t = rec.trace
    if got is None or t is None or not t.ops:
        return None
    from repro_torch.obs.trace import perf_counter_of
    w0 = rec.window.t0

    def at(x: float) -> float:
        return perf_counter_of(x) - w0

    stations: Dict[int, Dict[str, Tuple[float, float]]] = {}
    waits: List[Tuple[float, float, int]] = []
    for sp in got[1]["spans"]:
        s, e = at(sp["t0"]), at(sp["t0"] + sp["dur"])
        if sp["name"] in STATIONS:
            stations.setdefault(sp["trace_id"], {})[sp["name"]] = (s, e)
        elif sp["name"] == "dispatch.wait_host":
            waits.append((s, e, sp["trace_id"]))
    if not waits:
        return None
    waits.sort()
    lo, hi = waits[0][0], max(e for _, e, _ in waits)
    out = {k: 0.0 for k in STATIONS + ("other",)}
    starts = [s for s, _, _ in waits]
    for gs, ge in idle_gaps(t.busy(), lo, hi):
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, gs) - 1)
        while i < len(waits) and waits[i][0] < ge:
            ws, we, tid = waits[i]
            a, b = max(gs, ws), min(ge, we)
            if b > a:
                covered += b - a
                for k, v in split_by_station(a, b,
                                             stations.get(tid, {})).items():
                    out[k] += v
            i += 1
        out["other"] += (ge - gs) - covered
    return out


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The gaps between sorted, disjoint busy intervals, within [lo, hi]."""
    gaps, reach = [], lo
    for s, e in busy:
        if s > reach:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, e)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


def split_by_station(a: float, b: float,
                     spans: Dict[str, Tuple[float, float]]
                     ) -> Dict[str, float]:
    """Seconds of [a, b] in which a batch with these station spans stood
    at each station: Select until its Select span ends, Build until its
    Build span ends, Pack after. A batch whose spans are missing goes to
    "other"."""
    if not all(k in spans for k in STATIONS):
        return {"other": b - a}
    cut1, cut2 = spans["select"][1], spans["build"][1]

    def part(x: float, y: float) -> float:
        return max(0.0, min(b, y) - max(a, x))
    return {"select": part(float("-inf"), cut1),
            "build": part(cut1, cut2),
            "pack": part(cut2, float("inf"))}
