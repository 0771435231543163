"""PrecomputeManager + TierStage — the hybrid router's moving parts.

The PyTorch counterpart of ``repro.precompute.manager``: the offline build
and every refresh chunk run ``layer_major_embeddings`` under the engine's
``impl`` and on its device (so under impl="cuda" their Aggregates launch
the scatter-gather kernel); the tier and the router are host code. The
reference's telemetry histogram of refresh chunks belongs to the telemetry
plane, not ported yet.

The manager owns the deployment's EmbeddingTier: it builds (or loads)
the offline table at engine construction, demotes the dependency ball of
every graph update (wired into ``DecoupledEngine.invalidate``, which the
graph's update listener machinery already calls), and re-promotes
demoted vertices from a background refresh pool in ``chunk_size``
batches — each refresh chunk runs the SAME subset-mode layer-major
propagation as the full build, so a refreshed row is bitwise what a
fresh offline build would store.

``TierStage`` is the router: stage 0 of the host pipeline. All-fresh
batches short-circuit the pipeline entirely (Select/Build/Pack pass the
plan through untouched; ``run_device`` returns the gathered rows).
Mixed batches are SPLIT: the stale targets ride the online PPR pipeline
(padded to the fixed batch size, so the one compiled program still
serves), and ``run_device`` rejoins tier rows with online rows on the
ticket via the plan's ``online_index`` map (``torch.where`` on the
device, with no synchronize).
"""
from __future__ import annotations

import itertools
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np

from repro_torch.core.batchplan import BatchPlan, PlanStage
from repro_torch.core.program import Classify, Transform
from repro_torch.precompute.propagate import (agg_hops,
                                              check_precomputable,
                                              dependency_closure,
                                              layer_major_embeddings)
from repro_torch.precompute.tier import EmbeddingTier
from repro_torch.store.nbr_cache import as_vertex_ids


def output_dim(prog, cfg) -> int:
    """Embedding width the program emits per vertex (readout='target')."""
    f = cfg.f_in
    for _, op in prog.ops:
        if isinstance(op, Transform):
            f = cfg.f_hidden
        elif isinstance(op, Classify):
            f = cfg.num_classes
    return f


class PrecomputeManager:
    """Owns the tier, the refresh backlog, and the refresh worker pool
    for one deployment (engine holds exactly one, or None)."""

    def __init__(self, engine, pconf, params):
        self.engine = engine
        self.pconf = pconf
        self.params = params              # UNPADDED model params
        self.prog = engine.program
        check_precomputable(self.prog)
        self.hops = agg_hops(self.prog)
        graph = engine.graph
        self.tier = EmbeddingTier(
            graph.num_vertices, output_dim(self.prog, engine.cfg),
            budget_bytes=pconf.budget_bytes,
            degrees=np.asarray(graph.degrees))
        self.builds = 0
        self.refresh_chunks = 0
        self.refresh_errors = 0
        self._backlog: Dict[int, None] = {}     # ordered pending set
        self._lock = threading.Lock()
        self._futures: list = []
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=pconf.refresh_workers,
            thread_name_prefix="refresh")
        if pconf.artifact:
            from repro_torch.precompute.artifact import load_artifact
            emb = load_artifact(pconf.artifact, graph, engine.cfg, params)
            ids = self.tier.resident_ids
            self.tier.install(ids, emb[ids])
        else:
            ids = self.tier.resident_ids
            rows = self._propagate(
                None if len(ids) == graph.num_vertices else ids)
            self.tier.install(ids, rows)
            self.builds = 1

    def _propagate(self, out_ids):
        """Layer-major rows of ``out_ids`` (None: every vertex) under the
        engine's impl, on its device."""
        return layer_major_embeddings(
            self.engine.graph, self.prog, self.params,
            chunk_size=self.pconf.chunk_size, out_ids=out_ids,
            impl=self.engine.impl, device=self.engine.device)

    # -- serving -------------------------------------------------------------
    def lookup(self, targets):
        return self.tier.lookup(targets)

    # -- invalidation / refresh ----------------------------------------------
    def on_invalidate(self, vertices) -> int:
        """Demote the dependency ball of the touched vertices (every
        vertex whose embedding reads any of them within the program's
        aggregate radius) and enqueue them for refresh. Runs on the
        graph-update caller's thread, AFTER the CSR swap — the ball is
        computed on the post-update graph, whose edges are exactly the
        ones the demoted embeddings now depend on."""
        ids = as_vertex_ids(vertices)
        if not len(ids):
            return 0
        g = self.engine.graph
        snap = SimpleNamespace(indptr=g.indptr, indices=g.indices)
        ball = dependency_closure(snap, ids, self.hops)
        demoted = self.tier.demote(ball)
        if len(demoted):
            with self._lock:
                for v in demoted.tolist():
                    self._backlog[v] = None
            if self.pconf.auto_refresh:
                self._kick()
        return len(demoted)

    def _kick(self):
        with self._lock:
            if self._closed:
                return
            self._futures = [f for f in self._futures if not f.done()]
            if len(self._futures) < self.pconf.refresh_workers:
                self._futures.append(
                    self._pool.submit(self._refresh_loop))

    def _refresh_loop(self):
        """Pop ≤ chunk_size vertices off the backlog and recompute their
        rows via subset layer-major propagation; repeat until drained.
        Promotion is epoch-guarded: a demote landing mid-chunk wins (its
        re-enqueued entry recomputes against the newer graph)."""
        while not self._closed:
            with self._lock:
                take = list(itertools.islice(
                    self._backlog, self.pconf.chunk_size))
                for v in take:
                    del self._backlog[v]
            if not take:
                return
            ids = np.asarray(take, np.int64)
            epochs = self.tier.epoch_of(ids)
            tr = self.engine.tracer
            cm = tr.root_span("refresh.chunk", cat="precompute",
                              n_vertices=len(ids)) \
                if tr is not None else nullcontext()
            try:
                with cm:
                    rows = self._propagate(ids)
                self.tier.promote(ids, rows, epochs)
                with self._lock:
                    self.refresh_chunks += 1
            except Exception:       # a failed chunk must not kill the
                # worker; its vertices stay demoted (served online) until
                # the next demote re-adds them
                logging.getLogger(__name__).exception(
                    "tier refresh chunk failed")
                with self._lock:
                    self.refresh_errors += 1
                if self._closed:
                    return

    def drain(self, timeout: Optional[float] = 60.0):
        """Process the refresh backlog to completion (tests, maintenance
        windows, orderly shutdown): the caller thread helps drain, then
        waits out any in-flight worker chunks."""
        self._refresh_loop()
        with self._lock:
            futs = list(self._futures)
        for f in futs:
            f.result(timeout)
        self._refresh_loop()        # entries re-added by racing demotes

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        s = self.tier.stats()
        total = s["hits"] + s["misses"]
        with self._lock:
            backlog = len(self._backlog)
            chunks, errors = self.refresh_chunks, self.refresh_errors
        return {"enabled": True, **s,
                "hit_rate": s["hits"] / total if total else 0.0,
                "refresh_backlog": backlog, "refresh_chunks": chunks,
                "refresh_errors": errors, "builds": self.builds}

    def close(self):
        self._closed = True
        self._pool.shutdown(wait=True, cancel_futures=True)


class TierStage(PlanStage):
    """Stage 0 of the hybrid host pipeline: look every target up in the
    tier, short-circuit all-fresh batches, split mixed ones."""

    name = "tier"

    def __init__(self, engine):
        self.engine = engine

    def run(self, plan) -> BatchPlan:
        if not isinstance(plan, BatchPlan):   # pipeline entry: raw targets
            plan = BatchPlan(targets=np.asarray(plan))
        eng = self.engine
        tr = eng.tracer
        cm = tr.span("tier.lookup", cat="precompute") \
            if tr is not None else nullcontext()
        with cm:
            rows, fresh = eng.precompute.lookup(plan.targets)
            if tr is not None:
                tr.annotate(tier_fresh=int(fresh.sum()),
                            n_targets=len(fresh))
        plan.tier_rows = rows
        plan.tier_fresh = fresh
        if fresh.all():
            # fast path: row gather IS the answer — Select/Build/Pack
            # pass the plan through untouched, run_device returns rows
            plan.tier_done = True
            return plan
        if fresh.any():
            # split: only the stale targets ride the online pipeline,
            # padded to the fixed batch size (one compiled program);
            # run_device rejoins on online_index
            stale = plan.targets[~fresh]
            plan.online_index = np.zeros(len(fresh), np.int64)
            plan.online_index[~fresh] = np.arange(len(stale))
            plan.orig_targets = plan.targets
            plan.targets = np.concatenate(
                [stale, np.repeat(stale[-1:], len(fresh) - len(stale))])
        return plan
