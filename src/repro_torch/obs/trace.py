"""Per-batch tracing for the serving stack (the PyTorch package's copy of
``repro.obs.trace``, with the device span closed on a CUDA event).

The paper's latency story is a per-stage breakdown (Fig. 3) plus a
scheduler that *hides* the CPU<->accelerator hop (Fig. 7) — claims that
aggregate counters can only support by arithmetic on averages. This
module records what actually happened to individual batches:

* every ``StreamTicket`` can carry a ``TraceContext``; the scheduler
  opens one span per pipeline station (select / build / pack / device),
  and the engine adds child spans for the store gather and (sampled)
  per-ACK-op calibration runs. The device span opens when the batch's
  program is launched and closes when the CUDA event recorded after it is
  reached (``open_span`` / ``close_span``: launches are asynchronous, so
  a span around the launch alone would time the enqueue). The RPC layer
  (distributed.rpc) stitches in the graph hosts' remote spans
  (``ingest_remote``) with a ping-based clock-offset correction
  (``clock_sync``);
* finished spans land in a bounded ring (export) and the K slowest
  batches keep their FULL span trees in a flight recorder (forensics);
* per-span durations also feed fixed-memory ``LogHistogram``s, so the
  report surfaces exact-from-buckets p50/p90/p99 without unbounded
  lists.

Tracing is **opt-in and zero-cost when off**: with
``ServingConfig(trace=None)`` (the default) no tracer object exists and
every instrumentation site is a single ``is None`` test; traced and
untraced runs produce bitwise-identical outputs because spans only
*time* the existing calls — they never reorder or replace them.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.hist import LogHistogram

# One wall-clock anchor per process: span timestamps are
# ``time.time()``-anchored ``perf_counter`` deltas, so they are monotonic
# within the process at microsecond resolution while staying comparable
# across processes (after the ping-based offset correction).
_T0_WALL = time.time()
_T0_PERF = time.perf_counter()


def now() -> float:
    """Monotonic wall-clock seconds (see module anchor note)."""
    return _T0_WALL + (time.perf_counter() - _T0_PERF)


@dataclass(frozen=True)
class TraceConfig:
    """Knobs of the tracing subsystem (``ServingConfig(trace=...)``).

    sample_every     trace every Nth submitted batch (1 = all; the
                     default — span overhead is ~µs against ~ms batches)
    ring_capacity    finished spans retained for export (bounded; the
                     flight recorder keeps its own copies, so the K
                     slowest batches survive ring eviction)
    flight_k         slowest batches kept with full span trees
    calibrate_every  every Nth *traced* batch additionally runs the
                     instrumented per-ACK-op pass (obs.calib) to feed
                     the op x mode x size-bucket calibration table.
                     0 = off (the default: the pass re-executes the
                     program eagerly, roughly doubling that batch's
                     device work; its output is discarded, so serving
                     results stay bitwise-identical either way)
    """
    sample_every: int = 1
    ring_capacity: int = 8192
    flight_k: int = 8
    calibrate_every: int = 0

    def __post_init__(self):
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if self.ring_capacity < 1:
            raise ValueError("ring_capacity must be >= 1")
        if self.flight_k < 0:
            raise ValueError("flight_k must be >= 0")
        if self.calibrate_every < 0:
            raise ValueError("calibrate_every must be >= 0 (0 = off)")

    def describe(self) -> dict:
        return {"sample_every": self.sample_every,
                "ring_capacity": self.ring_capacity,
                "flight_k": self.flight_k,
                "calibrate_every": self.calibrate_every}


@dataclass
class TraceContext:
    """Identity of one traced batch: rides on the StreamTicket and (as
    two ints) in the RPC wire meta."""
    trace_id: int
    root_id: int
    seq: int = -1
    t_start: float = field(default_factory=now)


class _SpanHandle:
    """Mutable in-flight span; becomes an immutable dict when closed."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "track", "t0", "args")

    def __init__(self, name, cat, trace_id, span_id, parent_id, track):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.track = track
        self.t0 = now()
        self.args: Dict[str, Any] = {}

    def annotate(self, **kw) -> None:
        self.args.update(kw)


def span_dict(*, name: str, cat: str, trace_id: int, span_id: int,
              parent_id: Optional[int], t0: float, dur: float,
              host: str, track: str,
              args: Optional[dict] = None) -> dict:
    """The one span serialization every surface shares: plain JSON
    scalars only, so spans cross the wire codec and land in exported
    traces unchanged."""
    return {"name": name, "cat": cat, "trace_id": int(trace_id),
            "span_id": int(span_id),
            "parent_id": None if parent_id is None else int(parent_id),
            "t0": float(t0), "dur": float(dur), "host": host,
            "track": track, "args": dict(args or {})}


def _id_base() -> int:
    """Per-process span-id namespace: remote hosts allocate ids in their
    own range, so stitched trees never collide with local span ids."""
    return (os.getpid() & 0xFFFFF) << 40


class SpanAllocator:
    """Process-unique span-id source (used by Tracer and the graph host
    service, which emits spans without a full Tracer). The counter is
    class-level: with the inproc transport, client tracer and graph-host
    service live in ONE process and share the pid prefix, so separate
    counters would hand out colliding ids."""

    _counter = itertools.count(1)

    def __init__(self):
        self._base = _id_base()

    def next_id(self) -> int:
        return self._base | next(SpanAllocator._counter)


class Tracer:
    """Per-deployment trace collector (one per DecoupledEngine).

    Thread model: spans open/close on whatever thread runs the work
    (stage stations, the scheduler dispatcher, RPC workers). A
    thread-local stack carries the *current* span so nested
    instrumentation sites (store gather inside the device span, RPC
    annotations inside the stage span) need no context plumbing; the
    per-ticket ``TraceContext`` hops threads on the ticket itself.
    """

    def __init__(self, config: Optional[TraceConfig] = None,
                 host: str = "client"):
        self.config = config or TraceConfig()
        self.host = host
        self._ids = SpanAllocator()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.config.ring_capacity)
        self._live: Dict[int, List[dict]] = {}   # trace_id -> spans
        self._tls = threading.local()
        self._submitted = 0
        self.tickets_traced = 0
        self.spans_recorded = 0
        self.spans_dropped = 0          # ring evictions
        self.remote_spans = 0
        self.flight = FlightRecorder(self.config.flight_k)
        self.hists: Dict[str, LogHistogram] = {}
        # endpoint -> {"offset_s", "rtt_s"}: remote wall clock minus
        # local, estimated from ping round-trips (rpc.estimate_clock_
        # offsets); remote span timestamps subtract the offset
        self.clock_sync: Dict[str, dict] = {}

    # -- sampling ------------------------------------------------------------
    def maybe_trace(self, seq: int = -1) -> Optional[TraceContext]:
        """Per-submitted-batch sampling decision; returns a context for
        every ``sample_every``-th batch, else None (untraced batches pay
        exactly one None check everywhere downstream)."""
        with self._lock:
            n = self._submitted
            self._submitted += 1
            if n % self.config.sample_every:
                return None
            self.tickets_traced += 1
            ctx = TraceContext(trace_id=self._ids.next_id(),
                               root_id=self._ids.next_id(), seq=seq)
            self._live[ctx.trace_id] = []
        return ctx

    # -- thread-local current span -------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[_SpanHandle]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def current_ids(self) -> Optional[Tuple[int, int]]:
        """(trace_id, span_id) of the innermost open span on this
        thread, or None — what the RPC layer puts in the wire meta."""
        cur = self.current()
        return None if cur is None else (cur.trace_id, cur.span_id)

    def annotate(self, **kw) -> None:
        """Attach args to the innermost open span (no-op without one)."""
        cur = self.current()
        if cur is not None:
            cur.annotate(**kw)

    # -- spans ---------------------------------------------------------------
    def _handle(self, name, cat, trace_id, parent, track, args):
        h = _SpanHandle(name, cat, trace_id, self._ids.next_id(), parent,
                        track or name)
        # the recording OS thread keys the exporter's lane split: spans
        # from one thread form a stack, so B/E nesting per lane is exact
        # (an explicit ``tid`` arg names another lane)
        h.args["tid"] = threading.get_ident() & 0xFFFFFF
        if args:
            h.args.update(args)
        return h

    def open_span(self, name: str, *, ctx: Optional[TraceContext] = None,
                  cat: str = "stage", track: Optional[str] = None,
                  **args) -> Optional[_SpanHandle]:
        """Open a span that ``close_span`` ends later, possibly after
        other spans of this thread have opened and closed (the device span:
        launched, then waited on after the next batch's launch). Parenting
        as ``span``; returns None (record nothing) on an untraced batch.
        ``activate`` makes it the parent of spans opened meanwhile."""
        cur = self.current()
        if ctx is not None:
            trace_id, parent = ctx.trace_id, ctx.root_id
            if cur is not None and cur.trace_id == trace_id:
                parent = cur.span_id
        elif cur is not None:
            trace_id, parent = cur.trace_id, cur.span_id
        else:
            return None
        return self._handle(name, cat, trace_id, parent, track, args)

    @contextmanager
    def activate(self, h: Optional[_SpanHandle]):
        """Make ``h`` this thread's current span for the block (it stays
        open after)."""
        if h is None:
            yield None
            return
        stack = self._stack()
        stack.append(h)
        try:
            yield h
        finally:
            stack.pop()

    def close_span(self, h: Optional[_SpanHandle]) -> None:
        """End a span now: record it and feed its name's histogram."""
        if h is None:
            return
        dur = now() - h.t0
        self._record(span_dict(
            name=h.name, cat=h.cat, trace_id=h.trace_id,
            span_id=h.span_id, parent_id=h.parent_id, t0=h.t0, dur=dur,
            host=self.host, track=h.track, args=h.args))
        self.hist(h.name).record(dur)

    @contextmanager
    def span(self, name: str, *, ctx: Optional[TraceContext] = None,
             cat: str = "stage", track: Optional[str] = None, **args):
        """Open a span. Parenting: explicit ``ctx`` makes this a child
        of the batch's root; otherwise the innermost open span on this
        thread is the parent. With neither, the site is running an
        untraced batch — yield a no-op handle and record nothing."""
        h = self.open_span(name, ctx=ctx, cat=cat, track=track, **args)
        try:
            with self.activate(h):
                yield h
        finally:
            self.close_span(h)

    @contextmanager
    def root_span(self, name: str, *, cat: str = "stage",
                  track: Optional[str] = None, **args):
        """Open a PARENTLESS span in its own fresh trace — for
        background work that runs outside any ticket context, where
        ``span()`` would record nothing. The span lands straight in the
        export ring and feeds the per-name histogram; child ``span()``
        calls on the same thread nest under it as usual."""
        h = self._handle(name, cat, self._ids.next_id(), None, track, args)
        try:
            with self.activate(h):
                yield h
        finally:
            self.close_span(h)

    def _record(self, sp: dict) -> None:
        with self._lock:
            self.spans_recorded += 1
            live = self._live.get(sp["trace_id"])
            if live is not None:
                live.append(sp)
            else:                       # ticket already finished (late
                self._ring_append(sp)   # drain span) — straight to ring

    def _ring_append(self, sp: dict) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.spans_dropped += 1
        self._ring.append(sp)

    def ingest_remote(self, spans: Sequence[dict],
                      endpoint: str) -> None:
        """Stitch a graph host's spans into their batch's tree: shift
        timestamps by the endpoint's estimated clock offset (remote
        clock minus local — subtracting maps them onto THIS process's
        timeline) and tag the source endpoint."""
        off = self.clock_sync.get(endpoint, {}).get("offset_s", 0.0)
        with self._lock:
            for sp in spans:
                sp = dict(sp, t0=float(sp["t0"]) - off,
                          args=dict(sp.get("args") or {},
                                    endpoint=endpoint,
                                    clock_offset_s=round(off, 6)))
                self.remote_spans += 1
                self.spans_recorded += 1
                live = self._live.get(sp["trace_id"])
                if live is not None:
                    live.append(sp)
                else:
                    self._ring_append(sp)

    # -- ticket lifecycle ----------------------------------------------------
    def finish_ticket(self, ctx: TraceContext, *, error: bool = False,
                      **root_args) -> None:
        """Close a traced batch: emit its root span, move its tree to
        the export ring, offer it to the flight recorder, and feed the
        batch-latency histogram."""
        dur = now() - ctx.t_start
        # batch roots of PIPELINED batches overlap in time, so spread
        # them over 16 sub-lanes by seq (B/E events on one exporter lane
        # must nest; 16 > max_inflight for any sane depth)
        root = span_dict(name="batch", cat="batch",
                         trace_id=ctx.trace_id, span_id=ctx.root_id,
                         parent_id=None, t0=ctx.t_start, dur=dur,
                         host=self.host, track="batch",
                         args=dict(root_args, seq=ctx.seq, error=error,
                                   tid=ctx.seq % 16))
        with self._lock:
            tree = self._live.pop(ctx.trace_id, [])
            tree.append(root)
            for sp in tree:
                self._ring_append(sp)
            self.spans_recorded += 1
        self.hist("batch").record(dur)
        self.flight.offer(ctx.trace_id, dur, tree,
                          meta=dict(root_args, seq=ctx.seq, error=error))

    def discard_ticket(self, ctx: TraceContext) -> None:
        """Drop a context that never ran (submit raced a close)."""
        with self._lock:
            self._live.pop(ctx.trace_id, None)

    # -- metrics -------------------------------------------------------------
    def hist(self, name: str) -> LogHistogram:
        h = self.hists.get(name)
        if h is None:
            with self._lock:
                h = self.hists.setdefault(name, LogHistogram())
        return h

    # -- export --------------------------------------------------------------
    def export_spans(self) -> List[dict]:
        """Snapshot of the finished-span ring plus the flight recorder's
        retained trees (deduped by span id) — everything the chrome
        trace exporter needs."""
        with self._lock:
            spans = list(self._ring)
        seen = {sp["span_id"] for sp in spans}
        for entry in self.flight.entries():
            for sp in entry["spans"]:
                if sp["span_id"] not in seen:
                    seen.add(sp["span_id"])
                    spans.append(sp)
        return sorted(spans, key=lambda s: s["t0"])

    def report(self) -> dict:
        """The ``trace.*`` reporting section (versioned key map in
        core.report_schema)."""
        with self._lock:
            d = {"enabled": True, **self.config.describe(),
                 "tickets_traced": self.tickets_traced,
                 "spans": self.spans_recorded,
                 "spans_dropped": self.spans_dropped,
                 "remote_spans": self.remote_spans,
                 "host": self.host}
        d["hists"] = {k: h.to_dict() for k, h in self.hists.items()}
        d["flight"] = self.flight.summary()
        if self.clock_sync:
            d["clock_sync"] = {ep: {k: round(v, 6) for k, v in s.items()}
                               for ep, s in self.clock_sync.items()}
        return d


__all__ = ["TraceConfig", "TraceContext", "Tracer", "SpanAllocator",
           "span_dict", "now"]
