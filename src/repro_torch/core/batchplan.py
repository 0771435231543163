"""BatchPlan IR — the host side of prepare() as a typed, staged pipeline.

The PyTorch package's copy of ``repro.core.batchplan`` (numpy only). The
device side is an
inspectable instruction stream (core.program.AckProgram); this module is
the mirrored move for the HOST side. The paper's Fig. 3 shows INI +
subgraph construction dominating the non-compute budget, and its Fig. 7
scheduler hides that work under device execution — but a monolithic
``host_fn`` can only be hidden as a whole. Decomposing it into named
stages makes each piece separately observable
(a software Fig. 3 breakdown), separately cacheable (the Build stage's
subgraph-row cache), and separately schedulable (the scheduler pipelines
stage i of batch k under stage i+1 of batch k-1).

The artifact each stage produces/consumes is a ``BatchPlan``:

  Select   targets            -> PPR node lists (+ push frontiers), via
                                the neighborhood cache when configured
  Build    node lists         -> per-target SubgraphRows (induced
                                adjacency/edge blocks), via the
                                subgraph-row cache when configured —
                                a hit skips construction entirely
  Pack     rows               -> fixed-shape SubgraphBatch + the store
                                strategy's device payload + transfer
                                accounting

``DecoupledEngine`` instantiates the three stages and hands them to
``PipelineScheduler``; running them back-to-back on one thread is exactly
the old monolithic ``prepare()`` (and remains its spelling), so the staged
pipeline is bitwise-identical to the monolithic path by construction.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.subgraph import (SubgraphBatch, SubgraphRows,
                                       assemble_batch, build_subgraph_rows,
                                       edge_slots)
from repro_torch.store.nbr_cache import nbr_key


@dataclass
class BatchPlan:
    """The host-side compilation artifact for ONE micro-batch: every
    stage reads the fields of the previous stage and writes its own.
    ``device`` (the Pack stage's output) is what crosses to the device."""
    targets: np.ndarray
    # Select
    node_lists: Optional[List[np.ndarray]] = None
    frontiers: Dict[int, Optional[np.ndarray]] = field(default_factory=dict)
    nbr_hits: int = 0
    nbr_misses: int = 0
    row_gen: Optional[int] = None     # row-cache epoch at Select time
    # Build
    rows: Optional[List[SubgraphRows]] = None
    # the deployment's fixed edge layout (its e_pad): the rows' edge
    # arrays hold their real edge count, and take this many slots on the
    # wire (the layout a graph host's rows share with the reference's)
    e_pad: Optional[int] = None
    build_hits: int = 0
    build_misses: int = 0
    # induced-subgraph density stats (mean over the batch's rows): the
    # inputs to per-batch adaptive dispatch. Build fills them locally;
    # Pack recomputes them from the rows when Build ran behind a transport
    n_vertices: Optional[float] = None   # mean real vertices / subgraph
    n_edges: Optional[float] = None      # mean real edges / subgraph
    # Pack
    sb: Optional[SubgraphBatch] = None
    device: Optional[Dict[str, np.ndarray]] = None
    # Tier (hybrid precompute routing; set by precompute.TierStage)
    tier_rows: Optional[np.ndarray] = None   # [C, f_out] (stale rows 0)
    tier_fresh: Optional[np.ndarray] = None  # [C] bool freshness mask
    tier_done: bool = False       # all-fresh: skip Select/Build/Pack
    online_index: Optional[np.ndarray] = None  # stale slot -> online row
    orig_targets: Optional[np.ndarray] = None  # pre-split target list


def _note_density(plan: BatchPlan) -> None:
    """Batch density stats from the built rows (mean real vertex/edge
    counts per subgraph — the per-batch analogue of the graph-global
    avg_edges the static FLOP mux uses)."""
    if not plan.rows:
        return
    plan.n_vertices = float(np.mean([r.n_vertices for r in plan.rows]))
    plan.n_edges = float(np.mean([r.n_edges for r in plan.rows]))


class PlanStage:
    """One named stage of the host pipeline: ``run`` consumes and returns
    a BatchPlan. ``workers`` is the stage's scheduler parallelism (1 =
    strictly pipelined station)."""

    name = "stage"
    workers = 1

    def run(self, plan: BatchPlan) -> BatchPlan:
        raise NotImplementedError

    def close(self):
        pass


class SelectStage(PlanStage):
    """INI: PPR neighborhoods for the batch's targets, via the
    neighborhood cache when the policy has one. Hit/miss counts cover the
    batch's UNIQUE targets — duplicates collapse into one count, so tail
    padding (pad_targets repeats the last target) cannot inflate the hit
    rate with synthetic traffic. Owns a persistent INI thread pool (the
    paper's 8 host threads) so no pool is constructed per batch."""

    name = "select"

    def __init__(self, engine):
        self.engine = engine
        self._pool = ThreadPoolExecutor(
            max_workers=engine.num_threads,
            thread_name_prefix="ini") if engine.num_threads > 1 else None

    def run(self, plan) -> BatchPlan:
        from repro_torch.core.ini import ini_batch
        if not isinstance(plan, BatchPlan):   # pipeline entry: raw targets
            plan = BatchPlan(targets=np.asarray(plan))
        if plan.tier_done:       # all targets served from the tier:
            return plan          # nothing to select
        eng = self.engine
        cfg = eng.cfg
        n, a, e = cfg.receptive_field, cfg.ppr_alpha, cfg.ppr_eps
        targets = [int(t) for t in plan.targets]
        if eng.sg_cache is not None:
            # row-cache epoch BEFORE any graph read: a Build-stage insert
            # derived from this selection is dropped if an invalidate()
            # lands in between (same contract as the nbr cache put)
            plan.row_gen = eng.sg_cache.generation
        cache = eng.nbr_cache
        # the push frontier rides along whenever ANY cache will store the
        # result — it is both caches' exact invalidation footprint
        need_frontier = cache is not None or eng.sg_cache is not None
        if cache is None:
            computed = ini_batch(eng.graph, targets, n, a, e,
                                 eng.num_threads,
                                 with_frontier=need_frontier,
                                 executor=self._pool)
            if need_frontier:
                plan.node_lists = [nl for nl, _ in computed]
                plan.frontiers = {t: fr for t, (_, fr)
                                  in zip(targets, computed)}
            else:
                plan.node_lists = computed
            return plan
        found, missing = {}, []
        for t in dict.fromkeys(targets):          # unique, order-kept
            ent = cache.get_entry(nbr_key(t, n, a, e))
            if ent is None:
                missing.append(t)
            else:
                found[t] = ent[0]
                plan.frontiers[t] = ent[1]
        if missing:
            gen = cache.generation   # pre-computation epoch: an
            # invalidate() landing mid-push makes put() drop the result
            computed = ini_batch(eng.graph, missing, n, a, e,
                                 eng.num_threads, with_frontier=True,
                                 executor=self._pool)
            for t, (nl, frontier) in zip(missing, computed):
                # the full touched set rides along so invalidate() is
                # exact (an update below the top-N cutoff still drops us)
                cache.put(nbr_key(t, n, a, e), nl,
                          generation=gen, frontier=frontier)
                found[t] = nl
                plan.frontiers[t] = frontier
        plan.node_lists = [found[t] for t in targets]
        plan.nbr_hits = len(found) - len(missing)
        plan.nbr_misses = len(missing)
        tr = eng.tracer
        if tr is not None:           # annotate this batch's select span
            tr.annotate(nbr_hits=plan.nbr_hits,
                        nbr_misses=plan.nbr_misses,
                        n_targets=len(targets))
        return plan

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


class BuildStage(PlanStage):
    """Induced-subgraph construction: node lists -> per-target
    SubgraphRows, via the subgraph-row cache when the policy enables it.
    A cache hit skips the build entirely (the ROADMAP's subgraph-row
    caching); hit/miss counts cover unique targets, like Select. Rows hold
    every edge, at their real edge count (Pack refuses a batch whose
    subgraph is over the deployment's edge budget)."""

    name = "build"

    def __init__(self, engine):
        self.engine = engine

    def run(self, plan: BatchPlan) -> BatchPlan:
        if plan.tier_done:
            return plan
        eng = self.engine
        cfg = eng.cfg
        n = cfg.receptive_field
        plan.e_pad = eng.e_pad
        targets = [int(t) for t in plan.targets]
        cache = eng.sg_cache
        if cache is None:
            plan.rows = [build_subgraph_rows(eng.graph, nl[:n], n)
                         for nl in plan.node_lists]
            _note_density(plan)
            return plan
        built: Dict[int, SubgraphRows] = {}
        hits = 0
        by_target = dict(zip(targets, plan.node_lists))
        for t in dict.fromkeys(targets):          # unique, order-kept
            key = nbr_key(t, n, cfg.ppr_alpha, cfg.ppr_eps)
            rows = cache.get(key)
            if rows is None or rows.adj.shape[0] != n:
                rows = build_subgraph_rows(eng.graph, by_target[t][:n], n)
                cache.put(key, rows, generation=plan.row_gen,
                          frontier=plan.frontiers.get(t))
            else:
                hits += 1
            built[t] = rows
        plan.rows = [built[t] for t in targets]
        plan.build_hits = hits
        plan.build_misses = len(built) - hits
        _note_density(plan)
        tr = eng.tracer
        if tr is not None:           # annotate this batch's build span
            tr.annotate(build_hits=hits,
                        build_misses=plan.build_misses)
        return plan


def _pack_span(tracer, name: str):
    """A child span of the pack station's (no span on an untraced batch,
    nothing at all without a tracer)."""
    return nullcontext() if tracer is None \
        else tracer.span(name, track="pack")


class PackStage(PlanStage):
    """Assemble the fixed-shape SubgraphBatch from the built rows, attach
    the feature-store payload, and account the transfer (what this
    strategy ships vs. what the dense baseline would)."""

    name = "pack"

    def __init__(self, engine):
        self.engine = engine

    def run(self, plan: BatchPlan) -> BatchPlan:
        if plan.tier_done:
            return plan
        if plan.n_edges is None:     # Build ran behind a transport; the
            _note_density(plan)      # rows' scalars crossed the wire
        eng = self.engine
        src = eng._fsource
        n = eng.cfg.receptive_field
        tr = eng.tracer
        # the batch's edge layout follows its largest subgraph (none where
        # the program reads no edges; a subgraph over the edge budget is
        # refused, EdgeBudgetError), its [C, N, N] adjacency is made only
        # where the program reads it
        slots = edge_slots([r.n_edges for r in plan.rows],
                           eng.config.e_pad) if eng.needs_edges else 0
        with _pack_span(tr, "pack.assemble"):
            sb = assemble_batch(eng.graph, plan.targets, plan.node_lists,
                                plan.rows, n, slots,
                                build_feats=src.needs_host_feats,
                                dense=bool(eng.adj_keys))
        plan.sb = sb
        with _pack_span(tr, "pack.device_batch"):
            d = eng.device_batch(sb, include_feats=False)
        with _pack_span(tr, "pack.payload"):
            payload, dedup = src.host_payload(
                plan.node_lists, n,
                sb.feats if src.needs_host_feats else None)
        if dedup is not None:
            eng.last_dedup_ratio = dedup
        # transfer accounting: what this strategy ships vs. what the dense
        # baseline would (non-feature arrays + a full [C, N, f_pad] block)
        other = sum(int(a.nbytes) for a in d.values())
        shipped = other + sum(int(a.nbytes) for a in payload.values())
        dense = other + len(plan.node_lists) * n * eng.f_pad * 4
        d.update(payload)
        # sharded store: per-shard share of this payload's bytes (a pure
        # function of the payload: safe from concurrent stage threads)
        per_shard = getattr(src, "shard_metrics_for", None)
        eng.scheduler.note_host_metrics(
            bytes_shipped=shipped, bytes_dense=dense,
            cache_hits=plan.nbr_hits, cache_misses=plan.nbr_misses,
            build_hits=plan.build_hits, build_misses=plan.build_misses,
            dedup_ratio=dedup,
            shard_bytes=per_shard(payload) if per_shard else None,
            batch_edges=plan.n_edges,
            edges=int(sb.n_edges.sum()) if slots else 0,
            edge_slots=sb.edge_src.size)
        plan.device = d
        if tr is not None:           # annotate this batch's pack span
            tr.annotate(bytes_shipped=shipped, bytes_dense=dense)
        return plan
