"""Decoupled mini-batch GNN inference engine (paper Algorithm 2 + 3), in
PyTorch.

Host side: the staged BatchPlan pipeline (core.batchplan) — Select (PPR
neighborhoods via the nbr cache), Build (induced-subgraph rows via the
subgraph-row cache), Pack (store payload + transfer accounting) — each a
named stage the scheduler pipelines across consecutive batches. Device
side: the model's AckProgram (core.program) executed eagerly on
``ServingConfig.device``, through the package's CUDA kernels under
``impl="cuda"`` (the default) or plain PyTorch under ``impl="torch"``.
Shapes are fixed per (model, N, C), so one program serves every batch.

``DecoupledEngine.infer`` overlaps host preparation of batch i+1 with
device execution of batch i via core.scheduler (paper Fig. 7). The engine
owns ONE persistent ``PipelineScheduler`` for its whole lifetime.

Tracing (``ServingConfig.trace``, or ``attach_tracer`` on a running
deployment) gives every sampled batch a span tree (stations, store gather,
the copies' staging, on a card each layer's device time between CUDA
events, sampled calibration passes) and feeds the per-op calibration
table; adaptive dispatch (``ServingConfig.dispatch``) picks
each batch's dense/sg mode vector from that table's measured p50s
(core.dispatch) and serves it through a bounded cache of compiled
variants. Both are off by default, and neither changes what a batch
serves: a traced run is bitwise equal to an untraced one, and an adaptive
run to the engine forced to the mode vector it chose. Exploration passes
(calibration, warm-up, block autotune) never break serving: a failure is
logged and counted (``explore_failures`` in ``trace_report`` and
``dispatch_report``) where the reference swallows it.

The offline precompute tier (``ServingConfig.precompute``) prepends a
``TierStage`` to the host pipeline: tier-fresh targets skip Select, Build
and Pack and the device program, and a mixed batch runs the program on its
stale targets only, rejoined with the tier's rows on the device. The
resident and sharded feature stores come with their automatic repin
triggers (``StorePolicy.repin_every`` / ``repin_hit_floor``) on the
completion path.

Multi-host serving (``ServingConfig.transport`` "inproc" or "socket")
replaces Select and Build with one ``RemoteSelectBuildStage`` that ships
each batch's targets to a graph host (distributed.rpc) and grafts the
returned node lists and subgraph rows onto the plan; Pack and the program
stay here, on the card. The caches then live with the graph on the graph
hosts, and ``invalidate`` broadcasts to them. A remote engine serves the
bits of the local one.

The telemetry plane (``ServingConfig.telemetry``) joins the subsystems'
counters to a windowed metrics registry as collect-time callbacks, so a
metered engine serves the bits of an unmetered one; ``metrics_wire``
scrapes the graph hosts' registries too and merges them losslessly.
"""
from __future__ import annotations

import logging
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.batchplan import (BatchPlan, BuildStage, PackStage,
                                        SelectStage)
from repro_torch.core.config import ServingConfig
from repro_torch.core.program import (ProgramDecision, compile_program,
                                      execute, input_width_params, lower,
                                      required_adjacency, respecialize,
                                      specialize, stack_self_weights)
from repro_torch.core.scheduler import (PipelineScheduler, SchedulerStats,
                                        StreamTicket)
from repro_torch.core.subgraph import SubgraphBatch, default_edge_pad
from repro_torch.gnn.model import GNNConfig, init_gnn, params_to
from repro_torch.graphs.csr import CSRGraph
from repro_torch.store import (NeighborhoodCache, StorePolicy,
                               build_feature_source)
from repro_torch.store.feature_store import pad_feature_dim, to_device
from repro_torch.store.nbr_cache import SubgraphRowCache


def _pad128(f: int) -> int:
    return f + (-f) % 128


@dataclass
class InferenceResult:
    embeddings: np.ndarray           # [num_targets, f]
    stats: Optional[SchedulerStats]
    decision: ProgramDecision        # per-op mode decisions + summary


class DecoupledEngine:
    """One engine instance = one (graph, model, batch-size) deployment."""

    def __init__(self, graph: CSRGraph, cfg: GNNConfig, params=None,
                 config: Optional[ServingConfig] = None):
        """``params`` is this package's parameter tree (``init_gnn`` or
        ``gnn.model.params_from_jax``), moved to the config's device;
        None draws one from ``config.seed``."""
        config = config if config is not None else ServingConfig()
        self.config = config
        self.graph, self.cfg = graph, cfg
        self.device = torch.device(config.device)
        # observability (off by default, zero-cost when off: every site
        # downstream guards on ``tracer is None``); ``attach_tracer`` turns
        # it on, at the end of construction for ``config.trace`` or later
        self.tracer = None
        self._calib = None
        self._calib_count = 0
        # live telemetry plane (same contract: off by default, every
        # hot-path site guards on ``telemetry is None``)
        if config.telemetry is not None:
            from repro_torch.obs.metrics import Telemetry
            self.telemetry = Telemetry(config.telemetry, host="client")
            self._h_gather = self.telemetry.whist(
                "repro_store_gather_seconds",
                help="device-side feature gather wall time")
        else:
            self.telemetry = None
            self._h_gather = None
        # calibration / warm-up / autotune passes that raised (serving
        # went on; the reference swallows these)
        self.explore_failures = 0
        self.batch_size = config.batch_size
        self.num_threads = config.num_threads
        self.impl = config.impl
        mode = config.mode
        store = config.store
        self.store_policy = store
        self.last_dedup_ratio = None
        n = cfg.receptive_field
        # the edge layout the DSE plans for and graph hosts' rows cross the
        # wire in; the edge budget is config.e_pad alone (None: none), and
        # Pack lays each batch out in its largest subgraph's edges
        # (core.subgraph.edge_slots)
        self.e_pad = config.e_pad or default_edge_pad(graph, n)
        avg_edges = min(self.e_pad, n * float(graph.degrees.mean()))
        # compile the model through the lowering registry, then set each
        # op's mode mux from ITS kernel's FLOP model (mode="auto") or the
        # caller's force
        self.program, self.decision = specialize(
            lower(cfg), n=n, avg_edges=avg_edges, f_in=cfg.f_in,
            f_hidden=cfg.f_hidden,
            force=None if mode == "auto" else mode)
        self.mode = self.decision.mode
        self.needs_edges = any(d.mode == "sg" for d in self.decision)
        # ship only the adjacency arrays the specialized program reads
        self.adj_keys = required_adjacency(self.program)
        # per-batch adaptive dispatch (core.dispatch): only meaningful
        # with mode="auto" — a forced mode pins the mux, so the policy
        # never runs there (its batches are reported "forced")
        dconf = config.dispatch
        self.dispatch = None
        self._variants = None
        self._disp_counters: Dict = {}
        self._forced_dispatch = 0
        self._last_blocks: Dict[str, int] = {}
        self._static_assignment = {d.site: d.mode
                                   for d in self.decision if d.mux}
        if dconf is not None and mode == "auto":
            from repro_torch.core.dispatch import DispatchPolicy, VariantCache
            from repro_torch.obs.calib import CalibrationTable
            table = self._calib if self._calib is not None \
                else CalibrationTable()
            if dconf.artifact is not None:
                from repro_torch.ckpt.checkpoint import committed_steps
                from repro_torch.obs.calib import load_calibration
                if committed_steps(dconf.artifact):
                    # a committed table dispatches MEASURED from the first
                    # batch (its cells are populated, so no warm-up runs);
                    # stale stamps raise here
                    table = load_calibration(dconf.artifact, graph=graph,
                                             cfg=cfg, impl=self.impl)
            self._calib = table
            self.dispatch = DispatchPolicy(
                self.program, self.impl, table, n=n, f_in=cfg.f_in,
                f_hidden=cfg.f_hidden,
                warmup_passes=dconf.warmup_passes, seed=dconf.seed,
                autotune_blocks=dconf.autotune_blocks)
            self._variants = VariantCache(dconf.variant_capacity)
            # adaptive payload union: ANY per-batch mode vector must find
            # its arrays in the device batch, so ship the unspecialized
            # adjacency set + the edge list (unused keys change nothing)
            self.adj_keys = required_adjacency(lower(cfg))
            self.needs_edges = True
        if params is None:
            params = init_gnn(cfg, config.seed, device=self.device)
        params = params_to(params, self.device)
        self.params = params
        # the kernels' feature width: f_in padded to a multiple of 128 under
        # impl="cuda", as the reference pads under "pallas", so the two
        # kernel paths see the same shapes
        self.f_pad = _pad128(cfg.f_in) if self.impl == "cuda" \
            else cfg.f_in
        if self.f_pad != cfg.f_in:
            # zero-pad layer0 input-rows to match the padded feature
            # columns (padded features are zero, so this is exact); WHICH
            # weights are f_in-sized is read off the lowered program
            pad = self.f_pad - cfg.f_in
            l0 = dict(params["layer0"])
            for k in input_width_params(self.program):
                l0[k] = torch.nn.functional.pad(l0[k], (0, 0, 0, pad))
            self.params = dict(params, layer0=l0)
        if self.impl == "cuda":
            self.params = stack_self_weights(self.program, self.params)
        self._fsource = build_feature_source(graph, store, self.f_pad,
                                             self.device)
        if config.remote:
            # multi-host deployment: Select/Build run on graph hosts
            # behind the transport (distributed.rpc); the nbr/row caches
            # live WITH the graph over there, Pack + the program stay here
            # where the feature store and the card are
            from repro_torch.distributed.rpc import (RemoteSelectBuildStage,
                                                     build_host_pool)
            self.nbr_cache = None
            self.sg_cache = None
            self._host_pool = build_host_pool(config, graph=graph)
            self.stages = [RemoteSelectBuildStage(
                self, self._host_pool,
                workers=config.rpc_concurrency), PackStage(self)]
        else:
            self._host_pool = None
            self.nbr_cache = self._build_nbr_cache(store)
            # Build-stage subgraph-row cache: an explicit entry cap, or
            # bounded by bytes by default, each entry counted at what it
            # holds (~2N^2 floats + its edge arrays at the real edge count)
            if store.cache_subgraph_rows:
                cap = store.subgraph_capacity
                self.sg_cache = SubgraphRowCache(
                    store.nbr_capacity if cap is None else cap,
                    max_bytes=store.subgraph_budget_bytes if cap is None
                    else None)
            else:
                self.sg_cache = None
            # the host side as an explicit staged pipeline (Select ->
            # Build -> Pack); prepare() runs the same stages serially, so
            # the staged path is the monolithic one by construction
            self.stages = [SelectStage(self), BuildStage(self),
                           PackStage(self)]
        # offline precompute tier (hybrid serving): build or load the
        # layer-major embedding table and prepend the TierStage router;
        # tier-fresh targets skip Select/Build/Pack entirely. ``params``
        # (the local) is the UNPADDED tree: offline propagation runs on
        # unpadded features
        pconf = config.precompute
        if pconf is not None and (pconf.models is None
                                  or cfg.kind in pconf.models):
            from repro_torch.precompute.manager import (PrecomputeManager,
                                                        TierStage)
            self.precompute = PrecomputeManager(self, pconf, params)
            self.stages = [TierStage(self)] + self.stages
        else:
            self.precompute = None
        # auto-repin trigger state (StorePolicy.repin_every / _hit_floor)
        self._repin_auto = bool(store.repin_every or store.repin_hit_floor)
        self._repin_lock = threading.Lock()
        self._repin_batches = 0
        self._repin_base = (0, 0)       # (lookups, resident) at last repin
        # floor-trigger backoff: while the hit rate stays below the floor
        # even after a repin (working set > budget), checks space out
        # exponentially instead of rebuilding the table every batch
        self._floor_batches = 0
        self._floor_wait = 1
        # repins run on their own single worker, never on the scheduler's
        # dispatcher thread, where a table rebuild would stall completion
        # of every batch in flight
        self._repin_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repin") \
            if self._repin_auto else None
        self.auto_repins = 0
        self._attach_lock = threading.Lock()
        self.scheduler = PipelineScheduler(
            self.stages, self.run_device, depth=config.depth,
            max_inflight=config.max_inflight,
            on_batch=self._on_batch_done if self._repin_auto else None,
            telemetry=self.telemetry)
        if self.telemetry is not None:
            self._register_metrics()
        # graph-update streaming: cached neighborhoods / rows never serve
        # stale state
        if hasattr(graph, "register_listener"):
            graph.register_listener(self.invalidate)
        if config.trace is not None:
            self.attach_tracer(config.trace)

    def attach_tracer(self, config=None):
        """Turn tracing on in a running deployment (``config`` an
        ``obs.TraceConfig``; None: its defaults) and return the engine's
        tracer; the tracer already there, if any, stays and is returned.
        Batches submitted before the attach stay untraced: each ticket
        keeps the tracer that sampled it. There is no detach."""
        with self._attach_lock:
            if self.tracer is None:
                from repro_torch.obs.calib import CalibrationTable
                from repro_torch.obs.trace import TraceConfig, Tracer
                tracer = Tracer(config or TraceConfig())
                if self.device.type == "cuda":
                    # the card's event timer tied to the tracer's clock
                    tracer.anchor_gpu(self.device)
                if self._host_pool is not None:
                    # ping-based clock-offset estimate per graph host, so
                    # their spans stitch onto this process's timeline
                    from repro_torch.distributed.rpc import \
                        estimate_clock_offsets
                    tracer.clock_sync = estimate_clock_offsets(
                        self._host_pool)
                if self._calib is None:     # else adaptive dispatch's
                    self._calib = CalibrationTable()
                # the stages read the engine's; the scheduler samples
                # each batch submitted from now on
                self.tracer = tracer
                self.scheduler.tracer = tracer
            return self.tracer

    def _build_nbr_cache(self, policy: StorePolicy
                         ) -> Optional[NeighborhoodCache]:
        if policy.nbr_cache == "none":
            return None
        pinned = None
        if policy.nbr_cache == "pinned":
            pinned = policy.pinned_targets
            if pinned is None:
                k = min(self.graph.num_vertices,
                        policy.pinned_count or
                        max(1, policy.nbr_capacity // 4))
                pinned = np.argpartition(self.graph.degrees, -k)[-k:]
        return NeighborhoodCache(policy.nbr_capacity, pinned_targets=pinned)

    def _register_metrics(self):
        """Join the existing subsystem counters to the telemetry plane as
        collect-time callbacks: the hot path increments nothing twice —
        the registry samples each source at scrape/report time, so metered
        serving stays bitwise equal to unmetered."""
        reg = self.telemetry.registry
        stats = self.scheduler.stats
        src = self._fsource
        if self.nbr_cache is not None:
            c = self.nbr_cache
            reg.counter_fn("repro_nbr_cache_hits_total",
                           lambda: c.hits, help="neighborhood cache hits")
            reg.counter_fn("repro_nbr_cache_misses_total",
                           lambda: c.misses,
                           help="neighborhood cache misses")
            reg.counter_fn("repro_nbr_cache_evictions_total",
                           lambda: c.evictions,
                           help="neighborhood cache evictions")
        if self.sg_cache is not None:
            rc = self.sg_cache
            reg.counter_fn("repro_row_cache_hits_total",
                           lambda: rc.hits,
                           help="subgraph-row cache hits")
            reg.counter_fn("repro_row_cache_misses_total",
                           lambda: rc.misses,
                           help="subgraph-row cache misses")
        if hasattr(src, "lookups"):
            reg.counter_fn("repro_store_lookups_total",
                           lambda: src.lookups,
                           help="feature rows resolved")
            reg.counter_fn("repro_store_resident_lookups_total",
                           lambda: src.resident_lookups,
                           help="feature rows served device-resident")
        reg.counter_fn("repro_store_bytes_shipped_total",
                       lambda: stats.bytes_shipped,
                       help="host->device bytes actually shipped")
        reg.counter_fn("repro_store_bytes_dense_total",
                       lambda: stats.bytes_dense,
                       help="dense-baseline host->device bytes")
        if self._repin_auto:
            reg.counter_fn("repro_auto_repins_total",
                           lambda: self.auto_repins,
                           help="automatic residency rebalances")
        if self.dispatch is not None:
            pol, vc = self.dispatch, self._variants
            reg.counter_fn("repro_dispatch_decisions_total",
                           lambda: pol.decisions,
                           help="per-batch dispatch decisions taken")
            reg.counter_fn("repro_variant_cache_hits_total",
                           lambda: vc.hits,
                           help="compiled-variant cache hits")
            reg.counter_fn("repro_variant_cache_misses_total",
                           lambda: vc.misses,
                           help="compiled-variant cache misses (builds)")
            reg.counter_fn("repro_variant_cache_evictions_total",
                           lambda: vc.evictions,
                           help="compiled variants evicted (LRU bound)")
            reg.gauge_fn("repro_variant_cache_size", lambda: len(vc),
                         help="live compiled variants (<= capacity)")
        if self.precompute is not None:
            tier, mgr = self.precompute.tier, self.precompute
            reg.counter_fn("repro_tier_hits_total", lambda: tier.hits,
                           help="embedding-tier fresh hits")
            reg.counter_fn("repro_tier_misses_total",
                           lambda: tier.misses,
                           help="embedding-tier misses (online path)")
            reg.counter_fn("repro_tier_demotions_total",
                           lambda: tier.demotions,
                           help="tier rows demoted by invalidation")
            reg.counter_fn("repro_tier_promotions_total",
                           lambda: tier.promotions,
                           help="tier rows re-promoted by refresh")
            reg.counter_fn("repro_refresh_chunks_total",
                           lambda: mgr.refresh_chunks,
                           help="background refresh chunks completed")
            reg.counter_fn("repro_refresh_errors_total",
                           lambda: mgr.refresh_errors,
                           help="background refresh chunk failures")
            reg.gauge_fn("repro_refresh_backlog",
                         lambda: len(mgr._backlog),
                         help="vertices awaiting tier refresh")
        if self._host_pool is not None:
            reg.counter_fn("repro_rpc_calls_total",
                           lambda: stats.rpc_calls,
                           help="remote stage calls")
            reg.counter_fn("repro_rpc_retries_total",
                           lambda: stats.rpc_retries,
                           help="remote stage call retries")
            reg.counter_fn("repro_rpc_timeouts_total",
                           lambda: stats.rpc_timeouts,
                           help="remote stage call timeouts")
            reg.counter_fn("repro_rpc_errors_total",
                           lambda: stats.rpc_errors,
                           help="remote stage call errors")
            reg.counter_fn("repro_rpc_bytes_out_total",
                           lambda: stats.rpc_bytes_out,
                           help="bytes sent to graph hosts")
            reg.counter_fn("repro_rpc_bytes_in_total",
                           lambda: stats.rpc_bytes_in,
                           help="bytes received from graph hosts")
            quarantines = self.telemetry.counter(
                "repro_host_quarantines_total",
                help="graph-host quarantine episodes")
            events = self.telemetry.events

            def _on_quarantine(endpoint: str):
                quarantines.inc()
                events.emit("host_quarantine", severity="warn",
                            message=f"graph host {endpoint} quarantined",
                            endpoint=endpoint)

            self._host_pool.on_quarantine = _on_quarantine

    # -- host side ----------------------------------------------------------
    def plan(self, targets) -> BatchPlan:
        """Run the host pipeline's stages back-to-back on the caller
        thread and return the full BatchPlan artifact."""
        plan = BatchPlan(targets=np.asarray(targets))
        for stage in self.stages:
            plan = stage.run(plan)
        return plan

    def prepare(self, targets) -> Dict[str, np.ndarray]:
        """Monolithic host prep (all stages serially): the one-call
        spelling of the staged pipeline, bitwise-identical to it."""
        return self.plan(targets).device

    def device_batch(self, sb: SubgraphBatch,
                     include_feats: bool = True) -> Dict[str, np.ndarray]:
        d = {"mask": sb.mask}
        for k in self.adj_keys:     # only what the compiled program reads
            d[k] = sb.adj if k == "adj" else sb.adj_mean
        if include_feats:
            d["feats"] = pad_feature_dim(sb.feats, self.f_pad)
        if self.needs_edges:
            if sb.self_w is not None and sb.edge_w_mean is not None:
                d.update(edge_src=sb.edge_src, edge_dst=sb.edge_dst,
                         edge_w=sb.edge_w, self_w=sb.self_w,
                         edge_w_mean=sb.edge_w_mean)
            else:
                # externally constructed batch without the carried
                # extras: recover them from the dense adjacency
                n = sb.n
                self_w = sb.adj[:, np.arange(n), np.arange(n)]
                indeg = np.einsum("cij->ci",
                                  (sb.adj_mean > 0).astype(np.float32))
                d.update(edge_src=sb.edge_src, edge_dst=sb.edge_dst,
                         edge_w=sb.edge_w,
                         self_w=self_w.astype(np.float32))
                valid = sb.edge_w != 0
                dst_deg = np.take_along_axis(
                    np.maximum(indeg, 1.0), sb.edge_dst.astype(np.int64),
                    axis=1)
                d["edge_w_mean"] = np.where(valid, 1.0 / dst_deg, 0.0
                                            ).astype(np.float32)
        return d

    def run_device(self, device_batch) -> torch.Tensor:
        """Copy one batch to the device and launch its program; returns
        the [C, f] embeddings without waiting for the device (for an
        all-fresh tier batch: the tier's rows, on the host)."""
        plan = device_batch if isinstance(device_batch, BatchPlan) \
            else None                             # staged pipeline output
        if plan is not None:
            if plan.tier_done:
                # all-fresh: the tier's rows ARE the answer; no program
                # runs for this batch (and no calibration or dispatch)
                return torch.from_numpy(plan.tier_rows)
            device_batch = plan.device
        emb = self._run_program(plan, device_batch)
        if plan is not None and plan.online_index is not None:
            # mixed batch: the program ran on the stale targets only
            # (padded); rejoin with the tier rows in the original slot
            # order, on the device and without waiting for it
            dev = emb.device
            emb = torch.where(
                to_device(plan.tier_fresh, dev)[:, None],
                to_device(plan.tier_rows, dev),
                emb.index_select(0, to_device(plan.online_index, dev)))
        return emb

    def _run_program(self, plan: Optional[BatchPlan], device_batch
                     ) -> torch.Tensor:
        """The batch's feature gather and device program (launched, not
        waited for)."""
        db = dict(device_batch)
        src = self._fsource
        tr = self.tracer
        # a traced batch's CUDA timing events (obs.Tracer.gpu_marker)
        mark = None if tr is None else tr.gpu_marker(self.device)
        if mark is not None:
            mark("begin")
        if all(k in db for k in src.payload_keys):
            payload = {k: db.pop(k) for k in src.payload_keys}
            tg = time.perf_counter() if self._h_gather is not None \
                else 0.0
            if tr is None:
                feats = src.device_feats(payload)
            else:
                # child of the scheduler's "device" span (this thread's
                # current span); records nothing on an untraced batch
                with tr.span("store.gather", cat="store", store=src.name):
                    feats = src.device_feats(payload)
            if self._h_gather is not None:
                # the gather's host time: its copies and index_selects are
                # launched, not waited for
                self._h_gather.record(time.perf_counter() - tg)
        else:       # externally built dense batch (e.g. device_batch())
            feats = to_device(db.pop("feats"), self.device)
        if tr is None:
            batch = {k: to_device(v, self.device) for k, v in db.items()}
        else:
            # the pinned staging and the copies' enqueue (the copies run
            # on the device after; gpu.input times them there)
            with tr.span("h2d.stage", cat="copy"):
                batch = {k: to_device(v, self.device)
                         for k, v in db.items()}
        batch["feats"] = pad_feature_dim(feats, self.f_pad)
        if mark is not None:
            mark("input")
        with torch.inference_mode():
            if tr is not None and tr.config.calibrate_every \
                    and tr.current() is not None:
                # sampled instrumented per-op pass (obs.calib): its
                # outputs are DISCARDED — the program below is what gets
                # served, so outputs stay bitwise equal
                self._calib_count += 1
                if self._calib_count % tr.config.calibrate_every == 0:
                    from repro_torch.obs.calib import run_instrumented
                    with tr.span("calibrate", cat="calib"):
                        self._explore(run_instrumented, self.program,
                                      self.params, batch, self.impl,
                                      self._calib)
                    if mark is not None:
                        mark("calibrate")
            if self.dispatch is not None and plan is not None \
                    and plan.n_edges is not None:
                return self._dispatch_infer(plan, batch, mark)
            if self.config.dispatch is not None and self.dispatch is None:
                # forced mode: the policy is inert, but the mode counters
                # still tell the operator WHAT served and WHY ("forced")
                self._forced_dispatch += 1
                self._count_dispatch(self._static_assignment,
                                     {s: "forced"
                                      for s in self._static_assignment})
            emb, _ = execute(self.program, self.params, batch,
                             impl=self.impl, mark=mark)
        return emb

    # -- per-batch adaptive dispatch ----------------------------------------
    def _explore(self, fn, *args) -> None:
        """Run one exploration pass (calibration, warm-up, autotune): its
        failure must never break serving, so it is logged and counted in
        ``explore_failures`` instead of raised."""
        try:
            fn(*args)
        except Exception:
            self.explore_failures += 1
            logging.getLogger(__name__).exception(
                "exploration pass %s failed", getattr(fn, "__name__", fn))

    def _count_dispatch(self, assignment: Dict[str, str],
                        sources: Dict[str, str]) -> None:
        """Per-mux-op dispatch counters:
        ``repro_dispatch_total{op,mode,source}``. Counter handles are
        cached per label set so the hot path pays one dict probe."""
        if self.telemetry is None:
            return
        for site, m in assignment.items():
            key = (site, m, sources[site])
            c = self._disp_counters.get(key)
            if c is None:
                c = self._disp_counters[key] = self.telemetry.counter(
                    "repro_dispatch_total",
                    help="mux-op dispatch outcomes per batch",
                    op=site, mode=m, source=sources[site])
            c.inc()

    def _build_variant(self, assignment, blocks):
        """One compiled variant: the engine's program re-specialized to
        this mode vector (+ kernel block overrides), lowered to its step
        list once. The op stream never changes — only the per-site dense/sg
        mux — so every variant serves from the same fixed shapes."""
        prog = respecialize(self.program, dict(assignment))
        return compile_program(prog, self.impl, dict(blocks) or None)

    def _dispatch_infer(self, plan: BatchPlan, batch,
                        mark=None) -> torch.Tensor:
        """The adaptive device step: consult the policy with THIS batch's
        measured density, run the warm-up/autotune exploration pass when
        scheduled (outputs discarded), then serve through the bounded
        variant cache."""
        from repro_torch.core.dispatch import variant_key
        from repro_torch.obs.calib import (run_block_autotune,
                                           run_instrumented, size_bucket)
        pol = self.dispatch
        bucket = size_bucket(batch)
        avg_e = min(float(plan.n_edges), float(self.e_pad))
        dec = pol.decide(avg_e, bucket)
        if dec.blocks:
            self._last_blocks = dict(dec.blocks)
        if dec.warm_mode is not None:
            # instrumented exploration pass in the scheduled forced mode —
            # its outputs are DISCARDED (serving stays on dec.assignment
            # below), so warm-up batches serve what the engine with
            # dispatch off would
            warm = {s: dec.warm_mode for s in pol.sites}
            self._explore(run_instrumented,
                          respecialize(self.program, warm), self.params,
                          batch, self.impl, pol.table)
            if pol.autotune_blocks and self.impl == "cuda":
                self._explore(run_block_autotune, self.program, self.params,
                              batch, pol.table)
            if mark is not None:
                mark("explore")
        self._count_dispatch(dec.assignment, dec.site_sources)
        tr = self.tracer
        if tr is not None and tr.current() is not None:
            tr.annotate(dispatch_source=dec.source,
                        dispatch_bucket=dec.bucket,
                        dispatch_modes=",".join(
                            f"{s}={m}" for s, m
                            in sorted(dec.assignment.items())),
                        dispatch_blocks=",".join(
                            f"{k}={v}" for k, v
                            in sorted(dec.blocks.items())),
                        batch_avg_edges=round(dec.avg_edges, 1))
        fn = self._variants.get(
            variant_key(dec.assignment, dec.blocks),
            lambda: self._build_variant(dec.assignment, dec.blocks))
        emb, _ = fn(self.params, batch, mark=mark)
        return emb

    def dispatch_report(self) -> Optional[dict]:
        """Adaptive-dispatch state (the ``dispatch.*`` schema section):
        decision/source counters, warm-up schedule, variant-cache bounds
        and hit/evict counters, resolved block overrides, failed
        exploration passes. None when the deployment was built without
        ``ServingConfig(dispatch=...)`` — the section is omitted."""
        dconf = self.config.dispatch
        if dconf is None:
            return None
        if self.dispatch is None:    # forced mode: policy inert
            return {"enabled": True, "policy": "forced",
                    "impl": self.impl,
                    "mux_sites": sorted(self._static_assignment),
                    "decisions": self._forced_dispatch,
                    "sources": {"forced": self._forced_dispatch},
                    "artifact": dconf.artifact,
                    "explore_failures": self.explore_failures}
        d = self.dispatch.report()
        d.update(enabled=True, variants=self._variants.stats(),
                 blocks=dict(self._last_blocks),
                 artifact=dconf.artifact,
                 explore_failures=self.explore_failures)
        return d

    def save_calibration(self, path: Optional[str] = None) -> str:
        """Persist the live calibration table (per-op p50 cells + block
        autotune cells) as a committed artifact at ``path`` (default:
        ``DispatchConfig.artifact``); a later engine with the same
        graph/model/impl loads it and dispatches measured from the first
        batch."""
        from repro_torch.obs.calib import save_calibration
        dconf = self.config.dispatch
        path = path or (dconf.artifact if dconf is not None else None)
        if path is None:
            raise ValueError(
                "no artifact path: pass save_calibration(path=...) or set "
                "DispatchConfig(artifact=...)")
        if self._calib is None:
            raise ValueError(
                "no calibration table on this engine; enable "
                "ServingConfig(dispatch=...) or trace calibration")
        return save_calibration(path, self._calib, graph=self.graph,
                                cfg=self.cfg, impl=self.impl)

    def trace_report(self) -> dict:
        """Observability state of this deployment: tracing counters,
        per-span-name latency histograms, flight-recorder summary, the
        per-op calibration table and the failed exploration passes (the
        ``trace.*`` schema section). ``{"enabled": False}`` when the
        deployment was built without ``ServingConfig(trace=...)``."""
        if self.tracer is None:
            return {"enabled": False}
        from repro_torch.core.report_schema import trace_section
        d = trace_section(self.tracer, self._calib)
        d["explore_failures"] = self.explore_failures
        return d

    def export_trace(self, path: str) -> dict:
        """Write this deployment's finished spans (export ring + flight
        recorder trees) as a Perfetto-loadable chrome trace."""
        if self.tracer is None:
            raise ValueError(
                "tracing is off; construct the engine with "
                "ServingConfig(trace=TraceConfig(...)) to record spans")
        from repro_torch.obs.export import write_chrome_trace
        return write_chrome_trace(path, self.tracer.export_spans(),
                                  metadata={"config":
                                            self.config.describe()})

    # -- end-to-end ----------------------------------------------------------
    def pad_targets(self, targets: np.ndarray) -> np.ndarray:
        """Pad a tail chunk to the engine's fixed batch size C by repeating
        the last target (fixed shapes keep one program)."""
        C = self.batch_size
        targets = np.asarray(targets)
        if len(targets) == C:
            return targets
        if len(targets) > C or len(targets) == 0:
            raise ValueError(f"chunk size {len(targets)} vs C={C}")
        return np.concatenate(
            [targets, np.repeat(targets[-1:], C - len(targets))])

    def submit_chunk(self, targets, on_done=None,
                     on_traced=None) -> StreamTicket:
        """Streaming entry: enqueue ONE micro-batch (≤ C targets, tail is
        padded) on the persistent pipeline; returns a StreamTicket whose
        result is the [C, f] embedding block (``on_traced``: see
        ``PipelineScheduler.submit``)."""
        return self.scheduler.submit(self.pad_targets(np.asarray(targets)),
                                     on_done=on_done, on_traced=on_traced)

    def infer(self, targets, overlap: bool = True) -> InferenceResult:
        """Mini-batch inference for arbitrary #targets (chunks of C)."""
        targets = np.asarray(targets)
        C = self.batch_size
        chunks = [self.pad_targets(targets[i:i + C])
                  for i in range(0, len(targets), C)]
        outs, stats = self.scheduler.run(chunks, overlap=overlap)
        # every output's event has been waited on: .cpu() copies a
        # finished result
        emb = np.concatenate([o.cpu().numpy() for o in outs], axis=0)
        return InferenceResult(embeddings=emb[:len(targets)], stats=stats,
                               decision=self.decision)

    # -- store hooks ---------------------------------------------------------
    def invalidate(self, vertices) -> int:
        """Graph-update hook: drop every cached neighborhood AND every
        cached subgraph row whose push FRONTIER contains any of
        ``vertices``, and re-upload those vertices' device-resident feature
        rows from ``graph.features``. Returns the number of NEIGHBORHOOD
        entries dropped (row-cache drops are visible in
        store_report())."""
        if hasattr(self._fsource, "refresh_features"):
            self._fsource.refresh_features(vertices)
        if self.precompute is not None:
            # demote the dependency ball in the embedding tier (those
            # vertices serve online until refreshed)
            self.precompute.on_invalidate(vertices)
        if self._host_pool is not None:
            # multi-host: the caches live on the graph hosts — broadcast
            # the drop (best-effort; a dead host holds no live state)
            from repro_torch.store.nbr_cache import as_vertex_ids
            results = self._host_pool.broadcast(
                "invalidate", {"vertices": as_vertex_ids(vertices)})
            return sum(r["dropped"] for r in results if r is not None)
        if self.sg_cache is not None:
            self.sg_cache.invalidate(vertices)
        if self.nbr_cache is None:
            return 0
        return self.nbr_cache.invalidate(vertices)

    def _on_batch_done(self, ticket=None):
        """Pipeline completion hook: evaluate the policy's automatic repin
        triggers and hand the rebalance to the engine's single repin
        worker. The completion path stays light, and batches in flight
        keep their residency snapshot (the payload carries its
        generation), so a repin landing mid-stream never changes them.

        The hit-floor trigger backs off exponentially while the rate stays
        below the floor (a working set larger than the budget can never
        satisfy it) and re-arms as soon as a check passes."""
        pol = self.store_policy
        src = self._fsource
        with self._repin_lock:
            self._repin_batches += 1
            self._floor_batches += 1
            due = bool(pol.repin_every
                       and self._repin_batches >= pol.repin_every)
            if not due and pol.repin_hit_floor \
                    and self._floor_batches >= self._floor_wait:
                lk = src.lookups - self._repin_base[0]
                res = src.resident_lookups - self._repin_base[1]
                self._floor_batches = 0
                if lk > 0 and (res / lk) < pol.repin_hit_floor:
                    due = True
                    self._floor_wait = min(64, self._floor_wait * 2)
                else:
                    self._floor_wait = 1
            if not due:
                return
            self._repin_batches = 0
            self._repin_base = (src.lookups, src.resident_lookups)
            self.auto_repins += 1
        self._repin_pool.submit(self._auto_repin_job)

    def _auto_repin_job(self):
        try:
            self.repin()
        except Exception:            # a failed rebalance must not kill the
            # worker (serving goes on with the current residency)
            logging.getLogger(__name__).exception("automatic repin failed")

    def drain_repins(self, timeout: Optional[float] = 60.0):
        """Block until every triggered auto-repin has run (tests and
        orderly shutdown; serving never needs this)."""
        if self._repin_pool is not None:
            self._repin_pool.submit(lambda: None).result(timeout)

    def repin(self, **kwargs) -> dict:
        """Online residency rebalance (resident and sharded stores):
        re-derive the device-resident set from the PPR mass observed since
        start (and, sharded, even out skewed shards). Batches in flight
        keep their residency snapshot."""
        if not hasattr(self._fsource, "repin"):
            raise ValueError(
                f"store strategy {self._fsource.name!r} has no repin(); "
                "use StorePolicy(features='resident' | 'sharded', ...)")
        return self._fsource.repin(**kwargs)

    def store_report(self) -> dict:
        """Cache/transfer state of this deployment's store subsystem."""
        pol = self.store_policy.describe()
        if self.nbr_cache is not None:
            pol["pinned_count"] = self.nbr_cache.num_pinned_targets
        r = {"policy": pol, "features": self._fsource.report()}
        if self.nbr_cache is not None:
            r["nbr_cache"] = self.nbr_cache.stats()
        if self.sg_cache is not None:
            r["subgraph_cache"] = self.sg_cache.stats()
        if self._repin_auto:
            r["auto_repins"] = self.auto_repins
        if self._host_pool is not None:
            # multi-host: per-host health + the graph hosts' own cache
            # stats (best-effort — a down host reports health only)
            health = self._host_pool.report()
            remote = self._host_pool.broadcast("report", None)
            for h, rep in zip(health, remote):
                if rep is not None:
                    h["report"] = rep
            r["graph_hosts"] = health
        return r

    def telemetry_report(self) -> dict:
        """Live telemetry state of this deployment (the ``telemetry.*``
        schema section): windowed metric snapshot, SLO burn-rate rows,
        watchdog state, and the event ring. ``{"enabled": False}`` when the
        deployment was built without ``ServingConfig(telemetry=...)``."""
        if self.telemetry is None:
            return {"enabled": False}
        from repro_torch.core.report_schema import telemetry_section
        return telemetry_section(self.telemetry)

    def metrics_wire(self, cluster: bool = True) -> dict:
        """This deployment's metrics in wire form. With ``cluster=True`` on
        a multi-host deployment, every graph host's registry is scraped
        over the ``metrics`` RPC (best-effort broadcast) and merged
        losslessly into one cluster view — per-host histograms fold bucket
        by bucket, so the merged count is exactly the sum of the per-host
        counts."""
        if self.telemetry is None:
            raise ValueError(
                "telemetry is off; construct the engine with "
                "ServingConfig(telemetry=TelemetryConfig(...))")
        local = self.telemetry.to_wire()
        if not cluster or self._host_pool is None:
            return local
        from repro_torch.obs.metrics import merge_wire
        remote = self._host_pool.broadcast("metrics", None)
        return merge_wire([local] + [r for r in remote if r])

    def metrics_text(self, cluster: bool = True) -> str:
        """Prometheus text exposition of ``metrics_wire()`` (what an HTTP
        ``/metrics`` endpoint serves for this deployment)."""
        from repro_torch.obs.promexp import render_wire
        return render_wire(self.metrics_wire(cluster=cluster))

    def precompute_report(self) -> dict:
        """Embedding-tier state of this deployment (the ``precompute.*``
        schema section): residency, freshness, hit/demotion counters and
        refresh backlog. ``{"enabled": False}`` when the deployment was
        built without ``ServingConfig(precompute=...)`` (or this model
        kind is excluded from ``PrecomputeConfig.models``)."""
        from repro_torch.core.report_schema import precompute_section
        return precompute_section(self.precompute)

    def close(self):
        dconf = self.config.dispatch
        if self.dispatch is not None and dconf.save_on_close \
                and dconf.artifact:
            try:                     # a failed save must not block
                self.save_calibration()      # shutdown
            except Exception as e:
                warnings.warn(f"calibration save failed: {e}",
                              RuntimeWarning, stacklevel=2)
        if hasattr(self.graph, "unregister_listener"):
            self.graph.unregister_listener(self.invalidate)
        if self.precompute is not None:
            self.precompute.close()
        self.scheduler.close()
        if self.telemetry is not None:
            self.telemetry.close()
        if self._repin_pool is not None:
            self._repin_pool.shutdown(wait=True)
        for stage in self.stages:
            stage.close()
        if self._host_pool is not None:
            self._host_pool.close()

    def __enter__(self) -> "DecoupledEngine":
        return self

    def __exit__(self, *exc):
        self.close()
