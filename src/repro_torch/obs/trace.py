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
* the served path from request to device: the server's ``lane.form``
  and ``lane.admit``, the dispatcher's ``dispatch.wait_host`` (timed
  before the batch had a context, so recorded after the fact:
  ``record_span``), Pack's parts (``pack.assemble``, ``pack.device_batch``,
  ``pack.payload``) and ``h2d.stage``; on a card, a device span's CUDA
  timing events (``gpu_marker``) become its ``gpu.input``, ``gpu.layer``
  (arg ``l``), ``gpu.attention``, ``gpu.aggregate`` (each sg Aggregate)
  and ``gpu.tail`` children on track
  "gpu", placed on this clock by an anchor event (``anchor_gpu``);
* finished spans land in a bounded ring (export) and the K slowest
  batches keep their FULL span trees in a flight recorder (forensics);
* per-span durations also feed fixed-memory ``LogHistogram``s, so the
  report surfaces exact-from-buckets p50/p90/p99 without unbounded
  lists, and exact totals by name (``totals``: count, seconds, self
  seconds) that the ring's evictions do not touch.

``perf_counter_of`` maps a span time onto ``time.perf_counter()`` (the
clock ``torch.profiler`` traces are tied to) and ``from_perf_counter``
back.

Tracing is **opt-in and zero-cost when off**: with
``ServingConfig(trace=None)`` (the default) no tracer object exists until
``DecoupledEngine.attach_tracer`` makes one, and every instrumentation
site is a single ``is None`` test; traced and
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.hist import LogHistogram

# One wall-clock anchor per process: span timestamps are
# ``time.time()``-anchored ``perf_counter`` deltas, so they are monotonic
# within the process at microsecond resolution while staying comparable
# across processes (after the ping-based offset correction).
_T0_WALL = time.time()
_T0_PERF = time.perf_counter()
# the longest a GPU anchor serves before it is taken again: the card's
# event timer and the host's clock drift apart (4.5 us a second on an H100)
ANCHOR_S = 1.0
# marks that end a device interval without a span of its own: the sampled
# calibration and exploration passes, kept out of the next ``gpu.layer``
SKIP_MARKS = frozenset({"calibrate", "explore"})


def now() -> float:
    """Monotonic wall-clock seconds (see module anchor note)."""
    return _T0_WALL + (time.perf_counter() - _T0_PERF)


def perf_counter_of(t: float) -> float:
    """A span time (``now()``'s clock) as a ``time.perf_counter()``
    reading, by the module's one anchor: exact, no clock is read."""
    return _T0_PERF + (t - _T0_WALL)


def from_perf_counter(p: float) -> float:
    """A ``time.perf_counter()`` reading on ``now()``'s clock (the inverse
    of ``perf_counter_of``): for spans timed with perf_counter stamps."""
    return _T0_WALL + (p - _T0_PERF)


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
                 "track", "t0", "args", "marks")

    def __init__(self, name, cat, trace_id, span_id, parent_id, track):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.track = track
        self.t0 = now()
        self.args: Dict[str, Any] = {}
        # (label, CUDA event) pairs of a device span (``Tracer.gpu_marker``)
        self.marks: Optional[List[Tuple[str, Any]]] = None

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
        # span name -> self seconds (``totals``), kept as each span closes
        self._self_s: Dict[str, float] = {}
        # span id -> (start, end) of its host children closed so far
        self._kids: Dict[int, List[Tuple[float, float]]] = {}
        # (CUDA event, its time on now()'s clock): places the device spans
        # (``anchor_gpu``); the round trip bounds the placement's error
        self._gpu_anchor: Optional[Tuple[Any, float]] = None
        self._gpu_stream = None
        self.gpu_anchor_rtt_us: Optional[float] = None
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
        """End a span now: record it and feed its name's histogram. A
        device span's CUDA events (``gpu_marker``) become its ``gpu.*``
        children first: close it only once its last event has been
        reached."""
        if h is None:
            return
        if h.marks:
            self._resolve_marks(h)
        dur = now() - h.t0
        self._record(span_dict(
            name=h.name, cat=h.cat, trace_id=h.trace_id,
            span_id=h.span_id, parent_id=h.parent_id, t0=h.t0, dur=dur,
            host=self.host, track=h.track, args=h.args))

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

    def record_span(self, name: str, ctx: Optional[TraceContext],
                    t0: float, t1: float, *, cat: str = "stage",
                    track: Optional[str] = None, **args) -> None:
        """Record a span timed after the fact, [t0, t1] on ``now()``'s
        clock, as a child of the batch's root: for intervals timed before
        the batch had a context (the server's queue and admission). None
        ``ctx`` (an untraced batch) records nothing."""
        if ctx is None:
            return
        args["tid"] = threading.get_ident() & 0xFFFFFF
        self._record(span_dict(
            name=name, cat=cat, trace_id=ctx.trace_id,
            span_id=self._ids.next_id(), parent_id=ctx.root_id, t0=t0,
            dur=t1 - t0, host=self.host, track=track or name, args=args))

    def _record(self, sp: dict, host_child: bool = True) -> None:
        """Keep a finished span: its name's histogram and self time (net
        of its host children closed so far), then its trace's tree or the
        ring. A device span (``host_child=False``) is on another clock and
        leaves its parent's self time alone."""
        t0, dur = sp["t0"], sp["dur"]
        with self._lock:
            self.spans_recorded += 1
            self._add_time(sp["name"], dur,
                           self._self_time(sp["span_id"], t0, dur))
            if host_child and sp["parent_id"] is not None:
                self._kids.setdefault(sp["parent_id"], []).append(
                    (t0, t0 + dur))
            live = self._live.get(sp["trace_id"])
            if live is not None:
                live.append(sp)
            else:                       # ticket already finished (late
                self._ring_append(sp)   # drain span) — straight to ring

    def _add_time(self, name: str, dur: float, self_s: float) -> None:
        """Feed a closed span's histogram and self time (under the lock,
        so ``totals`` reads each name's count and sums together)."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = LogHistogram()
        h.record(dur)
        self._self_s[name] = self._self_s.get(name, 0.0) + self_s

    def _self_time(self, span_id: int, t0: float, dur: float) -> float:
        """``dur`` less the union of the span's closed host children,
        clipped to its interval (children on other threads may overlap)."""
        kids = self._kids.pop(span_id, None)
        if not kids:
            return dur
        covered, reach, t1 = 0.0, t0, t0 + dur
        for a, b in sorted(kids):
            a, b = max(a, reach), min(b, t1)
            if b > a:
                covered += b - a
                reach = b
        return dur - covered

    def totals(self) -> Dict[str, Tuple[int, float, float]]:
        """``{name: (count, total s, self s)}`` over every span this
        tracer timed so far (batch roots under "batch"; not the spans
        stitched in from graph hosts): the histograms' exact count and
        sum, whatever the ring evicted. Self time is a span's duration
        less what its host child spans cover; ``gpu.*`` spans are
        children on the device's clock and count toward no self time."""
        with self._lock:
            return {k: (h.count, h.total, self._self_s[k])
                    for k, h in self.hists.items()}

    # -- device spans --------------------------------------------------------
    def anchor_gpu(self, device=None, tries: int = 3) -> None:
        """Tie CUDA event times to ``now()``'s clock: record an event on an
        idle side stream of ``device`` (work in flight on the serving
        stream does not delay it) and wait for it, ``tries`` times; keep
        the try with the shortest round trip, placed at its midpoint. The
        round trip, ``gpu_anchor_rtt_us``, bounds how far a ``gpu.*`` span
        may sit from where the device ran it, with the clocks' drift since
        the anchor: device spans take a new one once it is ``ANCHOR_S``
        old (None ``device``: the anchor's own)."""
        import torch
        if device is not None:
            self._gpu_stream = torch.cuda.Stream(device)
        stream = self._gpu_stream
        best = None
        for _ in range(tries):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = now()
            ev.record(stream)
            ev.synchronize()
            t1 = now()
            if best is None or t1 - t0 < best[2] - best[1]:
                best = (ev, t0, t1)
        ev, t0, t1 = best
        self._gpu_anchor = (ev, (t0 + t1) / 2)
        self.gpu_anchor_rtt_us = (t1 - t0) * 1e6

    def gpu_marker(self, device) -> Optional[Callable[[str], None]]:
        """A ``mark(label)`` hook for the batch whose device span is this
        thread's current span (``device`` a ``torch.device``): each call
        records a CUDA timing event on the device's current stream. The
        first mark opens; each later one
        closes the interval since the previous and names it (``gpu.`` +
        label, "layer" numbered by ``l``), but "attention.begin" /
        "attention.end" and "aggregate.begin" / "aggregate.end", which
        bracket a ``gpu.attention`` / ``gpu.aggregate`` span inside the
        layer, and ``SKIP_MARKS``, which close the interval unnamed.
        None (mark nothing) off CUDA, before ``anchor_gpu``, or
        when this thread runs no traced batch."""
        h = self.current()
        if h is None or self._gpu_anchor is None or device.type != "cuda":
            return None
        import torch
        marks = h.marks = []
        stream = torch.cuda.current_stream(device)

        def mark(label: str) -> None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            marks.append((label, ev))
        return mark

    def _resolve_marks(self, h: _SpanHandle) -> None:
        """A device span's events as its ``gpu.*`` children on ``now()``'s
        clock: the first placed by the anchor (taken again first if it is
        older than ``ANCHOR_S``, so the batch's events lie within about
        the span's length of it), each later one by the elapsed time since
        the one before (exact to the event timer)."""
        marks, h.marks = h.marks, None
        if now() - self._gpu_anchor[1] > ANCHOR_S:
            self.anchor_gpu()
        anchor, t_anchor = self._gpu_anchor
        at = [t_anchor + anchor.elapsed_time(marks[0][1]) / 1e3]
        for (_, a), (_, b) in zip(marks, marks[1:]):
            at.append(at[-1] + a.elapsed_time(b) / 1e3)
        layer, prev, opened = 0, at[0], {}
        for (label, _), t in zip(marks[1:], at[1:]):
            part, _, edge = label.partition(".")
            if part in ("attention", "aggregate") and edge == "begin":
                opened[part] = t
                continue
            if part in ("attention", "aggregate") and edge == "end":
                self._gpu_span("gpu." + part, h, opened.pop(part), t,
                               l=layer)
                continue
            if label == "layer":
                self._gpu_span("gpu.layer", h, prev, t, l=layer)
                layer += 1
            elif label not in SKIP_MARKS:
                self._gpu_span("gpu." + label, h, prev, t)
            prev = t

    def _gpu_span(self, name: str, h: _SpanHandle, t0: float, t1: float,
                  **args) -> None:
        self._record(span_dict(
            name=name, cat="gpu", trace_id=h.trace_id,
            span_id=self._ids.next_id(), parent_id=h.span_id, t0=t0,
            dur=t1 - t0, host=self.host, track="gpu",
            args=dict(args, tid=0)), host_child=False)

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
            self._add_time("batch", dur,
                           self._self_time(ctx.root_id, ctx.t_start, dur))
            tree = self._live.pop(ctx.trace_id, [])
            tree.append(root)
            for sp in tree:
                self._ring_append(sp)
                # a child that closed after its parent left an entry
                self._kids.pop(sp["span_id"], None)
            self.spans_recorded += 1
        self.flight.offer(ctx.trace_id, dur, tree,
                          meta=dict(root_args, seq=ctx.seq, error=error))

    def discard_ticket(self, ctx: TraceContext) -> None:
        """Drop a context that never ran (submit raced a close)."""
        with self._lock:
            for sp in self._live.pop(ctx.trace_id, None) or ():
                self._kids.pop(sp["span_id"], None)
            self._kids.pop(ctx.root_id, None)

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
        if self.gpu_anchor_rtt_us is not None:
            d["gpu_anchor_rtt_us"] = round(self.gpu_anchor_rtt_us, 3)
        d["hists"] = {k: h.to_dict() for k, h in self.hists.items()}
        d["flight"] = self.flight.summary()
        if self.clock_sync:
            d["clock_sync"] = {ep: {k: round(v, 6) for k, v in s.items()}
                               for ep, s in self.clock_sync.items()}
        return d


__all__ = ["TraceConfig", "TraceContext", "Tracer", "SpanAllocator",
           "span_dict", "now", "perf_counter_of", "from_perf_counter"]
