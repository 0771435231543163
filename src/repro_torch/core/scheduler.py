"""Task scheduling on the host/accelerator boundary (paper §4.4, Fig. 7).

The paper overlaps, per PE: (a) CPU-side INI + subgraph build, (b) PCIe
transfer into on-chip buffers (triple-buffered), (c) accelerator compute.
Here (a) runs as a sequence of named host STAGES
(``core.batchplan.PlanStage``), each on its own worker station, so stage i
of batch k overlaps stage i+1 of batch k-1; (b) and (c) are the device
function, which copies through pinned memory and launches its kernels
asynchronously on the dispatcher thread's current CUDA stream.

Waiting for the device: right after the device function returns, the
dispatcher records a CUDA event on the stream that launched the work
(``torch.cuda.current_stream`` is per thread), and ``_drain`` waits on
that event — possibly after the next batch has been launched, which is
what overlaps batch i's device time with batch i+1's dispatch. On the CPU
the device function has finished when it returns.

``PipelineScheduler`` is a persistent streaming pipeline: construct it
once per deployment, then ``submit()`` micro-batches as they arrive or
``run()`` a list of them. ``SchedulerStats`` reports the paper's §5.4
quantities: t_initialization (first-batch host latency), per-stage sums,
and the achieved overlap fraction. (The reference's tracing and telemetry
hooks are not ported yet.)
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.report_schema import scheduler_summary

# per-batch raw-timing window: the newest RECENT_TIMES host/device times
# are kept verbatim; older ones roll off (cumulative totals stay exact)
RECENT_TIMES = 512


def record_event(output) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded on the current stream after the device work
    behind ``output`` was launched; None when ``output`` is no CUDA
    tensor (CPU work is done when it returns)."""
    if isinstance(output, torch.Tensor) and output.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(output.device))
        return ev
    return None


@dataclass
class SchedulerStats:
    t_wall: float = 0.0
    t_host_total: float = 0.0        # sum of per-batch host prep times
    t_device_total: float = 0.0      # sum of per-batch device times
    t_initialization: float = 0.0    # host prep of the FIRST batch
    n_batches: int = 0
    host_times: "deque" = field(
        default_factory=lambda: deque(maxlen=RECENT_TIMES))
    device_times: "deque" = field(
        default_factory=lambda: deque(maxlen=RECENT_TIMES))
    # per-stage host wall time totals — the paper's Fig. 3 breakdown
    stage_times: Dict[str, float] = field(default_factory=dict)
    # host->device transfer accounting (the paper's t_load, Eq. 2) and
    # the store's cache outcomes, fed via ``note_host_metrics``
    bytes_shipped: int = 0
    bytes_dense: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    build_hits: int = 0
    build_misses: int = 0
    last_dedup_ratio: Optional[float] = None
    batch_edges_total: float = 0.0
    n_density: int = 0

    @property
    def overlap_fraction(self) -> float:
        """How much of the smaller stage was hidden under the larger one.
        1.0 = perfect pipelining, 0.0 = fully serial."""
        lo = min(self.t_host_total, self.t_device_total)
        serial = self.t_host_total + self.t_device_total
        if lo <= 0 or serial <= self.t_wall:
            return 0.0 if serial <= self.t_wall else 1.0
        return min(1.0, (serial - self.t_wall) / lo)

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def build_hit_rate(self) -> float:
        total = self.build_hits + self.build_misses
        return self.build_hits / total if total else 0.0

    @property
    def batch_edges(self) -> float:
        return self.batch_edges_total / self.n_density \
            if self.n_density else 0.0

    @property
    def transfer_ratio(self) -> float:
        return self.bytes_shipped / self.bytes_dense if self.bytes_dense \
            else 1.0

    def summary(self) -> dict:
        return scheduler_summary(self)

    def record(self, t_host: float, t_device: float):
        if self.n_batches == 0:
            self.t_initialization = t_host
        self.host_times.append(t_host)
        self.device_times.append(t_device)
        self.t_host_total += t_host
        self.t_device_total += t_device
        self.n_batches += 1

    def merge_stage_times(self, stage_times: Dict[str, float]):
        for k, v in stage_times.items():
            self.stage_times[k] = self.stage_times.get(k, 0.0) + v


class StreamTicket:
    """Handle for one in-flight micro-batch: resolves to the device output
    (complete: its event has been waited on)."""

    __slots__ = ("item", "seq", "on_done", "t_submit", "t_host", "t_device",
                 "stage_times", "output", "cuda_event", "error", "_event",
                 "_host_future")

    def __init__(self, item: Any, seq: int,
                 on_done: Optional[Callable] = None):
        self.item = item
        self.seq = seq
        self.on_done = on_done
        self.t_submit = time.perf_counter()
        self.t_host = 0.0
        self.t_device = 0.0
        self.stage_times: Dict[str, float] = {}
        self.output: Any = None
        self.cuda_event = None       # recorded after the device step
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self._host_future = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"batch {self.seq} not done in {timeout}s")
        if self.error is not None:
            raise self.error
        return self.output


_SHUTDOWN = object()


class PipelineScheduler:
    """Persistent staged host->device streaming pipeline.

    stages          -> sequence of ``PlanStage`` objects, each run on its
                      own worker station so consecutive batches pipeline
                      through the stages
    device_fn(batch)-> device tensor; work is launched asynchronously
    depth           -> 1 runs ``run()`` serially; more lets the stations
                      run ahead of the device
    max_inflight    -> bound on submitted-but-incomplete batches;
                      ``submit()`` blocks past it (backpressure), default
                      2 * depth.
    on_batch        -> optional ``on_batch(ticket)`` completion hook,
                      fired on the dispatcher thread after stats are
                      recorded (the engine's auto-repin trigger point);
                      exceptions are swallowed.

    Lifecycle: lazily started on first submit/run; ``close()`` drains and
    tears down threads (the stage objects are owned — and closed — by
    their engine). ``self.stats`` accumulates over the scheduler's whole
    lifetime; ``run()`` additionally returns call-local stats.
    """

    def __init__(self, stages: Sequence, device_fn: Callable,
                 depth: int = 3, max_inflight: Optional[int] = None,
                 on_batch: Optional[Callable] = None):
        self.stages = list(stages)
        if not self.stages:
            raise ValueError("empty stage sequence")
        self.device_fn = device_fn
        self.depth = max(1, depth)
        self.max_inflight = max_inflight or 2 * self.depth
        self.on_batch = on_batch
        self.stats = SchedulerStats()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._order_q: "queue.Queue" = queue.Queue()
        self._slots = threading.BoundedSemaphore(self.max_inflight)
        self._inflight = 0
        self._active_since: Optional[float] = None
        self._seq = 0
        self._stage_pools: Optional[List[ThreadPoolExecutor]] = None
        self._dispatcher: Optional[threading.Thread] = None
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "PipelineScheduler":
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._dispatcher is not None:
                return self
            self._stage_pools = [
                ThreadPoolExecutor(
                    max_workers=max(1, getattr(st, "workers", 1)),
                    thread_name_prefix=f"sched-{st.name}")
                for st in self.stages]
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="sched-dispatch",
                daemon=True)
            self._dispatcher.start()
        return self

    def close(self):
        if self._dispatcher is None or self._closed:
            self._closed = True
            return
        self.flush()
        self._closed = True
        self._order_q.put(_SHUTDOWN)
        self._dispatcher.join(timeout=10)
        for p in self._stage_pools or ():
            p.shutdown(wait=True)
        # a submit() that raced past the closed-check may have enqueued
        # after _SHUTDOWN; fail its ticket rather than hang its waiter
        while True:
            try:
                t = self._order_q.get_nowait()
            except queue.Empty:
                break
            if t is not _SHUTDOWN:
                t.error = RuntimeError("scheduler closed before dispatch")
                self._complete(t)

    # -- host execution ------------------------------------------------------
    def _host_serial(self, item, stage_times: Dict):
        """Run the full host side inline (run()'s no-overlap path)."""
        v = item
        for st in self.stages:
            t0 = time.perf_counter()
            v = st.run(v)
            stage_times[st.name] = stage_times.get(st.name, 0.0) \
                + time.perf_counter() - t0
        return v

    def _stage_step(self, ticket: StreamTicket, i: int, value):
        st = self.stages[i]
        t0 = time.perf_counter()
        try:
            out = st.run(value)
        except BaseException as e:             # noqa: BLE001
            ticket.stage_times[st.name] = \
                ticket.stage_times.get(st.name, 0.0) \
                + time.perf_counter() - t0
            ticket._host_future.set_exception(e)
            return
        ticket.stage_times[st.name] = \
            ticket.stage_times.get(st.name, 0.0) + time.perf_counter() - t0
        if i + 1 < len(self.stages):
            try:
                self._stage_pools[i + 1].submit(self._stage_step, ticket,
                                                i + 1, out)
            except RuntimeError:               # racing close()
                ticket._host_future.set_exception(
                    RuntimeError("scheduler closed mid-pipeline"))
        else:
            ticket._host_future.set_result(
                (out, sum(ticket.stage_times.values())))

    # -- streaming interface -------------------------------------------------
    def submit(self, item, on_done: Optional[Callable] = None
               ) -> StreamTicket:
        """Enqueue one micro-batch; blocks when max_inflight is reached."""
        self.start()
        self._slots.acquire()
        if self._closed:             # close() ran while we were blocked
            self._slots.release()
            raise RuntimeError("scheduler is closed")
        with self._lock:
            t = StreamTicket(item, self._seq, on_done)
            self._seq += 1
            if self._inflight == 0:
                self._active_since = time.perf_counter()
            self._inflight += 1
        try:
            t._host_future = Future()
            self._stage_pools[0].submit(self._stage_step, t, 0, t.item)
            self._order_q.put(t)
        except RuntimeError as e:    # pool shut down by a racing close()
            with self._idle:
                self._inflight -= 1
                if self._inflight == 0:
                    self._active_since = None
                self._idle.notify_all()
            self._slots.release()
            raise RuntimeError("scheduler is closed") from e
        return t

    def note_host_metrics(self, *, bytes_shipped: int = 0,
                          bytes_dense: int = 0, cache_hits: int = 0,
                          cache_misses: int = 0, build_hits: int = 0,
                          build_misses: int = 0,
                          dedup_ratio: Optional[float] = None,
                          batch_edges: Optional[float] = None):
        """Accumulate transfer/cache counters for one prepared batch (safe
        from the stage worker threads and from run()'s serial path)."""
        with self._lock:
            s = self.stats
            s.bytes_shipped += int(bytes_shipped)
            s.bytes_dense += int(bytes_dense)
            s.cache_hits += int(cache_hits)
            s.cache_misses += int(cache_misses)
            s.build_hits += int(build_hits)
            s.build_misses += int(build_misses)
            if dedup_ratio is not None:
                s.last_dedup_ratio = float(dedup_ratio)
            if batch_edges is not None:
                s.batch_edges_total += float(batch_edges)
                s.n_density += 1

    def flush(self, timeout: Optional[float] = None):
        """Block until every submitted batch has completed."""
        with self._idle:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout):
                raise TimeoutError("scheduler flush timed out")

    def _complete(self, ticket: StreamTicket):
        with self._lock:
            self.stats.record(ticket.t_host, ticket.t_device)
            self.stats.merge_stage_times(ticket.stage_times)
        ticket._event.set()          # resolve BEFORE on_done: callbacks may
        if ticket.on_done is not None:           # call ticket.result()
            try:
                ticket.on_done(ticket)
            except Exception:        # callback errors must not kill pipeline
                pass
        if self.on_batch is not None:
            try:                     # completion hook (e.g. auto-repin) —
                self.on_batch(ticket)            # never kills the pipeline
            except Exception:
                pass
        # in-flight accounting last, so flush() implies callbacks finished
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0 and self._active_since is not None:
                self.stats.t_wall += time.perf_counter() - self._active_since
                self._active_since = None
            self._idle.notify_all()
        self._slots.release()

    def _dispatch_loop(self):
        pending: Optional[StreamTicket] = None
        while True:
            try:
                # only poll while a batch is pending drain; otherwise block
                if pending is None:
                    t = self._order_q.get()
                else:
                    t = self._order_q.get(timeout=0.05)
            except queue.Empty:
                self._drain(pending)
                pending = None
                continue
            if t is _SHUTDOWN:
                if pending is not None:
                    self._drain(pending)
                break
            td0 = time.perf_counter()
            try:
                hb, t.t_host = t._host_future.result()
                td0 = time.perf_counter()
                t.output = self.device_fn(hb)
                t.cuda_event = record_event(t.output)
            except BaseException as e:             # noqa: BLE001
                t.error = e
            if pending is not None:                # drain batch i-1 while
                self._drain(pending)               # batch i computes
                pending = None
            t.t_device = time.perf_counter() - td0
            if t.error is not None:
                self._complete(t)
            elif self._order_q.empty():
                # nothing behind us: finish now for lowest tail latency
                self._drain(t, extra_device_time=True)
            else:
                pending = t

    def _drain(self, ticket: StreamTicket, extra_device_time: bool = False):
        t0 = time.perf_counter()
        try:
            if ticket.cuda_event is not None:
                ticket.cuda_event.synchronize()
        except BaseException as e:                 # noqa: BLE001
            ticket.error = e
        if extra_device_time:
            ticket.t_device += time.perf_counter() - t0
        self._complete(ticket)

    # -- batch interface (offline inference) ---------------------------------
    def run(self, items: Sequence, overlap: bool = True):
        """Run a list of micro-batches; returns (outputs, call stats).

        overlap=False executes fully serially on the caller thread (the
        paper's no-pipelining baseline); both paths accumulate into the
        cumulative ``self.stats``.
        """
        call = SchedulerStats(n_batches=len(items))
        with self._lock:       # store-metric baseline for call-local delta
            base = (self.stats.bytes_shipped, self.stats.bytes_dense,
                    self.stats.cache_hits, self.stats.cache_misses,
                    self.stats.build_hits, self.stats.build_misses,
                    self.stats.batch_edges_total, self.stats.n_density)
        t0 = time.perf_counter()
        if not overlap or self.depth == 1:
            outs = []
            for it in items:
                st_times: Dict[str, float] = {}
                th = time.perf_counter()
                hb = self._host_serial(it, st_times)
                th = time.perf_counter() - th
                td = time.perf_counter()
                out = self.device_fn(hb)
                ev = record_event(out)
                if ev is not None:
                    ev.synchronize()
                td = time.perf_counter() - td
                call.host_times.append(th)
                call.device_times.append(td)
                call.merge_stage_times(st_times)
                with self._lock:
                    self.stats.record(th, td)
                    self.stats.merge_stage_times(st_times)
                    self.stats.t_wall += th + td
                if self.on_batch is not None:
                    try:             # completion hook fires on the serial
                        self.on_batch(None)      # path too (no ticket)
                    except Exception:
                        pass
                outs.append(out)
        else:
            tickets = [self.submit(it) for it in items]
            outs = [t.result() for t in tickets]
            call.host_times = [t.t_host for t in tickets]
            call.device_times = [t.t_device for t in tickets]
            for t in tickets:
                call.merge_stage_times(t.stage_times)
        call.t_wall = time.perf_counter() - t0
        call.t_host_total = sum(call.host_times)
        call.t_device_total = sum(call.device_times)
        call.t_initialization = call.host_times[0] if call.host_times \
            else 0.0
        with self._lock:
            call.bytes_shipped = self.stats.bytes_shipped - base[0]
            call.bytes_dense = self.stats.bytes_dense - base[1]
            call.cache_hits = self.stats.cache_hits - base[2]
            call.cache_misses = self.stats.cache_misses - base[3]
            call.build_hits = self.stats.build_hits - base[4]
            call.build_misses = self.stats.build_misses - base[5]
            call.batch_edges_total = self.stats.batch_edges_total - base[6]
            call.n_density = self.stats.n_density - base[7]
            call.last_dedup_ratio = self.stats.last_dedup_ratio
        return outs, call
