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

This is the local path of the reference's engine: remote transports,
tracing, telemetry, adaptive dispatch, the precompute tier and the sharded
feature store are not ported yet (ServingConfig refuses them). The
single-device resident store is, with its automatic repin triggers
(``StorePolicy.repin_every`` / ``repin_hit_floor``) on the completion path.
"""
from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.batchplan import (BatchPlan, BuildStage, PackStage,
                                        SelectStage)
from repro_torch.core.config import ServingConfig
from repro_torch.core.program import (ProgramDecision, execute,
                                      input_width_params, lower,
                                      required_adjacency, specialize)
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
        self.batch_size = config.batch_size
        self.num_threads = config.num_threads
        self.impl = config.impl
        mode = config.mode
        store = config.store
        self.store_policy = store
        self.last_dedup_ratio = None
        n = cfg.receptive_field
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
        self._fsource = build_feature_source(graph, store, self.f_pad,
                                             self.device)
        self.nbr_cache = self._build_nbr_cache(store)
        # Build-stage subgraph-row cache, byte-bounded by default (one
        # entry is ~2N^2 floats + the edge arrays)
        if store.cache_subgraph_rows:
            cap = store.subgraph_capacity
            if cap is None:
                entry = 2 * n * n * 4 + 2 * n * 4 + 4 * self.e_pad * 4
                cap = max(1, min(store.nbr_capacity,
                                 store.subgraph_budget_bytes // entry))
            self.sg_cache = SubgraphRowCache(cap)
        else:
            self.sg_cache = None
        # the host side as an explicit staged pipeline (Select -> Build ->
        # Pack); prepare() runs the same stages serially, so the staged
        # path is the monolithic one by construction
        self.stages = [SelectStage(self), BuildStage(self), PackStage(self)]
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
        self.scheduler = PipelineScheduler(
            self.stages, self.run_device, depth=config.depth,
            max_inflight=config.max_inflight,
            on_batch=self._on_batch_done if self._repin_auto else None)
        # graph-update streaming: cached neighborhoods / rows never serve
        # stale state
        if hasattr(graph, "register_listener"):
            graph.register_listener(self.invalidate)

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
        the [C, f] embeddings without waiting for the device."""
        if isinstance(device_batch, BatchPlan):   # staged pipeline output
            device_batch = device_batch.device
        db = dict(device_batch)
        src = self._fsource
        if all(k in db for k in src.payload_keys):
            payload = {k: db.pop(k) for k in src.payload_keys}
            feats = src.device_feats(payload)
        else:       # externally built dense batch (e.g. device_batch())
            feats = to_device(db.pop("feats"), self.device)
        batch = {k: to_device(v, self.device) for k, v in db.items()}
        batch["feats"] = pad_feature_dim(feats, self.f_pad)
        with torch.inference_mode():
            emb, _ = execute(self.program, self.params, batch,
                             impl=self.impl)
        return emb

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

    def submit_chunk(self, targets, on_done=None) -> StreamTicket:
        """Streaming entry: enqueue ONE micro-batch (≤ C targets, tail is
        padded) on the persistent pipeline; returns a StreamTicket whose
        result is the [C, f] embedding block."""
        return self.scheduler.submit(self.pad_targets(np.asarray(targets)),
                                     on_done=on_done)

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
        """Online residency rebalance of the resident store: re-derive
        the device-resident set from the PPR mass observed since start.
        Batches in flight keep their residency snapshot."""
        if not hasattr(self._fsource, "repin"):
            raise ValueError(
                f"store strategy {self._fsource.name!r} has no repin(); "
                "use StorePolicy(features='resident', ...)")
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
        return r

    def close(self):
        if hasattr(self.graph, "unregister_listener"):
            self.graph.unregister_listener(self.invalidate)
        self.scheduler.close()
        if self._repin_pool is not None:
            self._repin_pool.shutdown(wait=True)
        for stage in self.stages:
            stage.close()

    def __enter__(self) -> "DecoupledEngine":
        return self

    def __exit__(self, *exc):
        self.close()
