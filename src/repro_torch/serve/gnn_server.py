"""Multi-model streaming GNN serving (the paper's deployment shape).

The paper's headline system property (§4.5): ONE accelerator
configuration from design space exploration serves a SET of GNN models
(GCN, GraphSAGE, GAT), with the task scheduler hiding host work under
device compute. ``GNNServer`` is that shape as a running server, the
PyTorch counterpart of ``repro.serve.gnn_server``:

* several ``DecoupledEngine``s register under one server, validated
  against a shared ``DSEPlan`` from ``core.dse.explore`` for the H100
  (admission control: a model outside the plan raises ``PlanViolation``);
* each model gets its own micro-batcher lane: requests route by model
  name, batch up to C with a tail-latency deadline, and stream into the
  engine's persistent ``PipelineScheduler``;
* per-model latency percentiles (p50/p90/p99) and the achieved host/device
  overlap fraction are reported, per model and aggregate.

The reference's telemetry, tracing, dispatch and precompute planes (its
``metrics_wire``/``metrics_text`` and those report sections) are not
ported.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.config import ServingConfig
from repro_torch.core.dse import DSEPlan, H100Spec, explore, validate_models
from repro_torch.core.engine import DecoupledEngine
from repro_torch.core.report_schema import (SCHEMA_VERSION, stages_section,
                                            store_section)
from repro_torch.obs.hist import LogHistogram, Reservoir

DEFAULT_MODEL = "default"


@dataclass
class Request:
    target: int
    model: str = DEFAULT_MODEL
    t_enqueue: float = field(default_factory=time.perf_counter)
    t_done: float = 0.0
    embedding: Optional[np.ndarray] = None
    error: Optional[BaseException] = None

    @property
    def latency(self) -> float:
        return self.t_done - self.t_enqueue


@dataclass
class ServerStats:
    """Per-lane latency state in O(1) memory: request and batch latencies
    stream into fixed-size ``LogHistogram``s (exact count/mean, quantiles
    within one ~2.2% bucket); ``recent`` keeps the newest 256 raw request
    latencies verbatim."""
    hist: LogHistogram = field(default_factory=LogHistogram)
    batch_hist: LogHistogram = field(default_factory=LogHistogram)
    recent: Reservoir = field(default_factory=lambda: Reservoir(256))
    n_batches: int = 0

    def record(self, latency_s: float) -> None:
        self.hist.record(latency_s)
        self.recent.record(latency_s)

    def record_batch(self, latency_s: float) -> None:
        self.batch_hist.record(latency_s)
        self.n_batches += 1

    def merge(self, other: "ServerStats") -> "ServerStats":
        self.hist.merge(other.hist)
        self.batch_hist.merge(other.batch_hist)
        for v in other.recent.values():
            self.recent.record(v)
        self.n_batches += other.n_batches
        return self

    @property
    def nbytes(self) -> int:
        """Fixed footprint of the stats structures."""
        return self.hist.nbytes + self.batch_hist.nbytes \
            + self.recent.capacity * 8

    def percentiles(self) -> Dict[str, float]:
        if not self.hist.count:
            return {}
        return {**self.hist.percentiles(),
                "mean": self.hist.mean,
                "batch_mean": self.batch_hist.mean,
                "n": self.hist.count,
                "hist": self.hist.to_dict()}


class _ModelLane:
    """One registered model: request queue + micro-batcher thread that
    streams padded batches into the engine's persistent scheduler."""

    def __init__(self, name: str, engine: DecoupledEngine,
                 max_wait_s: float):
        self.name = name
        self.engine = engine
        self.max_wait_s = max_wait_s
        self.q: "queue.Queue[Request]" = queue.Queue()
        self.stats = ServerStats()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- micro-batching ------------------------------------------------------
    def _collect_batch(self) -> List[Request]:
        c = self.engine.batch_size
        out: List[Request] = []
        try:
            out.append(self.q.get(timeout=0.05))
        except queue.Empty:
            return out
        deadline = out[0].t_enqueue + self.max_wait_s
        while len(out) < c:
            tmo = deadline - time.perf_counter()
            if tmo <= 0:
                # deadline passed: still take whatever is already queued
                # (no extra waiting) so batches fill under load
                try:
                    while len(out) < c:
                        out.append(self.q.get_nowait())
                except queue.Empty:
                    pass
                break
            try:
                out.append(self.q.get(timeout=tmo))
            except queue.Empty:
                break
        return out

    def _batch_loop(self):
        while not self._stop.is_set():
            reqs = self._collect_batch()
            if not reqs:
                continue
            targets = np.array([r.target for r in reqs])
            t0 = time.perf_counter()
            # streams into the engine's one persistent pipeline; blocks
            # only when the scheduler's in-flight bound applies backpressure
            self.engine.submit_chunk(
                targets,
                on_done=lambda tk, rs=reqs, ts=t0: self._on_done(rs, ts, tk))

    def _on_done(self, reqs: List[Request], t0: float, ticket):
        t1 = time.perf_counter()
        if ticket.error is not None:
            # the cause goes on every request of the failed batch so
            # drain() can raise at once instead of timing out
            for r in reqs:
                r.error = ticket.error
            self.stats.record_batch(t1 - t0)
            return
        # the ticket's event has been waited on: a finished result
        emb = ticket.output.cpu().numpy()
        for i, r in enumerate(reqs):
            r.embedding = emb[i]
            r.t_done = t1
            self.stats.record(r.latency)
        self.stats.record_batch(t1 - t0)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._stop.clear()       # server may stop() then start() again
            self._thread = threading.Thread(
                target=self._batch_loop, name=f"lane-{self.name}",
                daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # a later start() would race a still-live consumer on the
                # same queue: refuse instead of doubling up
                raise RuntimeError(f"lane {self.name!r} did not stop")
            self._thread = None
        self.engine.scheduler.flush(timeout=60)

    def report(self) -> dict:
        """This lane's slice of the report schema (core.report_schema):
        latency.* request percentiles, stages.* pipeline breakdown, store.*
        transfer + subsystem state."""
        sched = self.engine.scheduler.stats
        return {"kind": self.engine.cfg.kind,
                # compiled ACK program: per-op mode mux of this lane
                "ack": {"mode": self.engine.mode,
                        "summary": self.engine.decision.summary,
                        "ops": [{"site": d.site, "op": d.op,
                                 "mode": d.mode}
                                for d in self.engine.decision]},
                "latency": dict(self.stats.percentiles()),
                "stages": stages_section(sched),
                "store": {**store_section(sched),
                          **self.engine.store_report()}}


class GNNServer:
    """Multi-tenant micro-batching router over DecoupledEngines.

    ``register(name, engine)`` admits a model under the server's shared
    ``DSEPlan`` (recomputed over ALL registered configs unless a fixed plan
    was passed; then admission is validate-only). ``submit`` routes a
    request to its model's lane. max_wait_s bounds tail latency: a partial
    batch is flushed (padded with repeats) once the oldest queued request
    exceeds the wait.

    Single model: ``GNNServer(engine)`` registers it as "default" and
    ``submit(target)`` with one registered model needs no model name.
    """

    def __init__(self, engine: Optional[DecoupledEngine] = None,
                 max_wait_s: Optional[float] = None, *,
                 plan: Optional[DSEPlan] = None,
                 spec: Optional[H100Spec] = None,
                 config: Optional[ServingConfig] = None):
        self.config = config
        self.max_wait_s = max_wait_s if max_wait_s is not None else (
            config.max_wait_s if config is not None
            else ServingConfig.__dataclass_fields__["max_wait_s"].default)
        self.spec = spec or H100Spec()
        self.plan = plan
        self._plan_fixed = plan is not None
        self._lanes: Dict[str, _ModelLane] = {}
        self._started = False
        if engine is not None:
            self.register(DEFAULT_MODEL, engine)

    # -- model registry ------------------------------------------------------
    def register(self, name: str,
                 engine: Optional[DecoupledEngine] = None, *,
                 graph=None, cfg=None, params=None,
                 config: Optional[ServingConfig] = None) -> "GNNServer":
        """Admit a model: pass a constructed ``engine``, or pass ``graph=``
        + ``cfg=`` (+ optional ``config=ServingConfig(...)``, defaulting to
        the server's) and the server builds the engine."""
        if name in self._lanes:
            raise ValueError(f"model {name!r} already registered")
        if engine is None:
            if graph is None or cfg is None:
                raise TypeError(
                    "register() needs either an engine or graph= + cfg= "
                    "(+ optional config=ServingConfig(...))")
            engine = DecoupledEngine(graph, cfg, params=params,
                                     config=config or self.config)
        elif config is not None:
            raise TypeError(
                "config= applies only when the server builds the engine "
                "(omit engine=, pass graph= and cfg=)")
        engines = [ln.engine for ln in self._lanes.values()] + [engine]
        cfgs = [e.cfg for e in engines]
        e_pads = [e.e_pad for e in engines]
        if self._plan_fixed:
            validate_models(self.plan, [engine.cfg], self.spec,
                            [engine.e_pad])
        else:
            # one shared plan covering every registered model (the paper's
            # DSE over the model SET), then admission-check each
            plan = explore(cfgs, self.spec, e_pads)
            validate_models(plan, cfgs, self.spec, e_pads)
            self.plan = plan
        lane = _ModelLane(name, engine, self.max_wait_s)
        self._lanes[name] = lane
        if self._started:
            lane.start()
        return self

    @property
    def models(self) -> List[str]:
        return list(self._lanes)

    def engine_for(self, model: str) -> DecoupledEngine:
        return self._lanes[model].engine

    # -- request path --------------------------------------------------------
    def submit(self, target: int, model: Optional[str] = None) -> Request:
        if model is None:
            if len(self._lanes) != 1:
                raise ValueError(
                    f"model name required, registered: {self.models}")
            model = next(iter(self._lanes))
        lane = self._lanes.get(model)
        if lane is None:
            raise KeyError(f"unknown model {model!r}; "
                           f"registered: {self.models}")
        r = Request(int(target), model=model)
        lane.q.put(r)
        return r

    def drain(self, requests: List[Request], timeout: float = 60.0):
        t0 = time.perf_counter()
        while any(r.t_done == 0.0 for r in requests):
            failed = next((r for r in requests if r.error is not None),
                          None)
            if failed is not None:
                raise RuntimeError(
                    f"request for vertex {failed.target} via "
                    f"{failed.model!r} failed") from failed.error
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError("serve drain timed out")
            time.sleep(0.002)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if not self._lanes:
            raise RuntimeError("no models registered")
        self._started = True
        for lane in self._lanes.values():
            lane.start()

    def stop(self):
        for lane in self._lanes.values():
            lane.stop()
        self._started = False

    # -- reporting -----------------------------------------------------------
    def model_stats(self, model: str) -> ServerStats:
        return self._lanes[model].stats

    @property
    def stats(self) -> ServerStats:
        """Aggregate over all models (the single-model view)."""
        agg = ServerStats()
        for lane in self._lanes.values():
            agg.merge(lane.stats)
        return agg

    def report(self) -> dict:
        """Per-model latency.*/stages.*/store.* under the shared plan: the
        versioned report schema (core.report_schema.SCHEMA_VERSION)."""
        per_model = {n: ln.report() for n, ln in self._lanes.items()}
        return {"schema_version": SCHEMA_VERSION,
                "models": per_model,
                "plan": {"block_f": self.plan.block_f,
                         "c_core": self.plan.c_core,
                         "buffer_depth": self.plan.buffer_depth,
                         "smem_used": self.plan.smem_used},
                "aggregate": {"latency": self.stats.percentiles()}}
