"""Per-batch adaptive dense/sg dispatch with measured-cost calibration (the
PyTorch package's counterpart of ``repro.core.dispatch``).

The static mode mux (``specialize(mode="auto")``) picks dense vs
scatter-gather ONCE at engine construction from a FLOP model fed a
graph-global average degree. Real mini-batches are not average: a
sampler that lands on a hub produces a dense induced subgraph while the
next batch is a sparse fringe, and the best mode flips batch to batch
(the paper's ACK mux exists precisely because neither mode wins
everywhere). This module makes the choice **per batch** and **per mux
op**, driven by *measured* step latencies instead of the FLOP model:

- ``DispatchPolicy.decide`` consults the ``CalibrationTable`` p50s at
  the batch's size bucket. Cost comparison is SECTION-level: for each
  program section it enumerates the 2^k mode assignments over that
  section's mux sites, prices each assignment as the sum of measured
  p50s over the steps ``compile_steps`` would actually emit (this is
  what makes it fusion-aware — the kernel peephole collapses dense
  Aggregate+Residual+Transform into ONE fused step, so dense's measured
  cost includes the fusion win that a per-op comparison cannot see),
  and takes the argmin over assignments whose cells are all populated.
- Cold cells fall back to the FLOP model — fed THIS batch's measured
  density, not the graph-global prior — and consume a **warmup slot**:
  a deterministic seeded schedule (``WarmupSchedule``) that forces one
  instrumented eager pass per slot through all-dense / all-sg mode
  vectors so both columns of the table fill in. Warmup passes discard
  their outputs; serving stays on the fallback decision, so a
  dispatch-enabled run is bitwise-identical to its forced-mode twin.
- ``VariantCache`` bounds the set of live variants: each distinct (mode
  vector, block overrides) pair is one compiled program — the step list
  ``program.compile_steps`` returns for it, bound by
  ``program.compile_program`` (PyTorch runs eagerly: there is no jit) —
  kept in an LRU of ``variant_capacity`` entries with hit/miss/evict
  counters. Eviction is safe while a batch is in flight because the
  caller holds its own reference to the returned callable.

Sources (telemetry label + report key):
  measured  — every mux site priced from populated table cells
  flop      — at least one site fell back to the FLOP model, and the
              exploration schedule was already exhausted
  warmup    — fallback decision, and this batch consumed a warmup slot
              (an instrumented pass in ``warm_mode`` should run)
  forced    — engine is in a forced mode; the policy never ran
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from itertools import product
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.program import (compile_steps, mux_sites,
                                      respecialize, specialize)
from repro_torch.obs.calib import (CalibrationTable, WarmupSchedule,
                                   best_block, op_label, op_mode)

SOURCES = ("measured", "flop", "warmup", "forced")


@dataclass(frozen=True)
class DispatchConfig:
    """Per-batch adaptive dispatch knobs (``ServingConfig.dispatch``).

    ``warmup_passes``: instrumented exploration passes per mode side per
    size bucket (so ``2 * warmup_passes`` sampled batches run an extra
    eager pass before the table can go fully measured). 0 disables
    exploration — dispatch then stays on the FLOP fallback unless a
    persisted table supplies the cells.
    ``variant_capacity``: LRU bound on live compiled mode-vector
    variants; each entry is one compiled step list, so the default is
    deliberately small — a k-mux-site program has at most 2^k useful
    variants x a few block choices.
    ``artifact``: directory for table persistence. When it holds a
    committed calibration checkpoint the engine loads it at init
    (stale stamps raise ``CalibrationArtifactError``) and dispatches
    measured from the first batch; with ``save_on_close`` the engine
    writes the table back on ``close()``.
    ``autotune_blocks``: let the exploration passes also time the
    kernels' block knobs and serve with the measured-best ``block_f`` /
    ``block_cols`` (cuda impl only). Both knobs leave results bitwise
    unchanged (``obs.calib.run_block_autotune``), so adaptive == forced
    holds with autotune on.
    """
    warmup_passes: int = 4
    seed: int = 0
    variant_capacity: int = 8
    autotune_blocks: bool = True
    artifact: Optional[str] = None
    save_on_close: bool = True

    def __post_init__(self):
        if self.warmup_passes < 0:
            raise ValueError("warmup_passes must be >= 0")
        if self.variant_capacity < 1:
            raise ValueError("variant_capacity must be >= 1 (the engine "
                             "always holds at least the current variant)")

    def describe(self) -> dict:
        return {"warmup_passes": self.warmup_passes, "seed": self.seed,
                "variant_capacity": self.variant_capacity,
                "autotune_blocks": self.autotune_blocks,
                "artifact": self.artifact,
                "save_on_close": self.save_on_close}


@dataclass(frozen=True)
class DispatchDecision:
    """One batch's dispatch outcome."""
    assignment: Dict[str, str]        # mux site -> dense|sg
    site_sources: Dict[str, str]      # mux site -> measured|flop|warmup
    source: str                       # batch-level: measured|flop|warmup
    warm_mode: Optional[str]          # forced mode for an instrumented
    #                                   pass this batch (None = no pass)
    blocks: Dict[str, int]            # kernel block overrides (may be {})
    bucket: int
    avg_edges: float


def variant_key(assignment: Dict[str, str],
                blocks: Dict[str, int]) -> Tuple:
    """Canonical hashable key for one compiled variant."""
    return (tuple(sorted(assignment.items())),
            tuple(sorted((k, v) for k, v in blocks.items()
                         if v is not None)))


class VariantCache:
    """Bounded LRU of compiled program variants.

    Keyed by ``variant_key``; values are the compiled callables. ``get``
    builds on miss OUTSIDE the lock (a builder may be slow — serializing
    it behind the cache lock would stall concurrent device steps), so two
    threads racing the same cold key may both build; the second build is
    discarded and the cached one returned.
    Evicting an entry that a caller is still executing is safe: the
    caller holds its own reference, eviction only drops the cache's.
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple, builder: Callable[[], Callable]) -> Callable:
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return fn
            self.misses += 1
        fn = builder()
        with self._lock:
            if key not in self._entries:
                self._entries[key] = fn
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1
            else:                      # lost the build race — reuse theirs
                self._entries.move_to_end(key)
            return self._entries[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[Tuple]:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "size": len(self._entries),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


class DispatchPolicy:
    """Measured-cost per-batch mode selection over one program.

    Holds the program's mux-site list, the live ``CalibrationTable``,
    and the warmup schedule. ``decide`` is cheap on the steady path:
    the section-level 2^k argmin is cached per ``(bucket,
    table.version)``, so once the table stops growing each batch costs
    one dict probe (plus the trivial FLOP fallback arithmetic while any
    section is still cold).
    """

    def __init__(self, program, impl: str, table: CalibrationTable, *,
                 n: int, f_in: int, f_hidden: int,
                 warmup_passes: int = 4, seed: int = 0,
                 autotune_blocks: bool = True):
        self.program = program
        self.impl = impl
        self.table = table
        self.n = int(n)
        self.f_in = int(f_in)
        self.f_hidden = int(f_hidden)
        self.autotune_blocks = bool(autotune_blocks)
        self.warmup = WarmupSchedule(passes=warmup_passes, seed=seed)
        self.sites: Tuple[str, ...] = mux_sites(program)
        self.decisions = 0
        self.source_counts: Dict[str, int] = {s: 0 for s in SOURCES}
        self._lock = threading.Lock()
        # (bucket, table.version) -> partial {site: mode}; measured
        # sections only, missing sites mean "fall back to FLOP"
        self._mcache: Dict[Tuple[int, int], Dict[str, str]] = {}
        self._bcache: Dict[Tuple[int, int], Dict[str, int]] = {}

    # -- section-level measured pricing -------------------------------

    def _section_cost(self, sec: str, assignment: Dict[str, str],
                      bucket: int) -> Optional[float]:
        """Sum of measured p50s over the steps this section compiles to
        under ``assignment``, or None if any step's cell is cold."""
        seq = getattr(respecialize(self.program, assignment), sec)
        total = 0.0
        for ops, _ in compile_steps(seq, self.impl):
            p50 = self.table.lookup(op_label(ops),
                                    op_mode(ops, self.impl), bucket)
            if p50 is None:
                return None
            total += p50
        return total

    def _measured_assignment(self, bucket: int) -> Dict[str, str]:
        """Per-section argmin over fully-priced mode assignments.

        A section joins the result only when >= 2 of its assignments
        price completely — a single priced candidate is not a
        comparison, it is whatever warmup happened to run first."""
        key = (bucket, self.table.version)
        with self._lock:
            hit = self._mcache.get(key)
        if hit is not None:
            return hit
        out: Dict[str, str] = {}
        for sec, _ in self.program.layer_sections():
            sites = [s for s in self.sites if s.startswith(sec)]
            if not sites:
                continue
            priced = []
            for modes in product(("dense", "sg"), repeat=len(sites)):
                asg = dict(zip(sites, modes))
                cost = self._section_cost(sec, asg, bucket)
                if cost is not None:
                    priced.append((cost, sorted(asg.items())))
            if len(priced) >= 2:
                out.update(dict(min(priced)[1]))
        with self._lock:
            self._mcache[key] = out
            # stale versions of the same bucket are dead weight
            for k in [k for k in self._mcache
                      if k[0] == bucket and k != key]:
                del self._mcache[k]
        return out

    def _flop_assignment(self, avg_edges: float) -> Dict[str, str]:
        """Static-model fallback, fed the BATCH's measured density."""
        _, dec = specialize(self.program, n=self.n, avg_edges=avg_edges,
                            f_in=self.f_in, f_hidden=self.f_hidden)
        return {d.site: d.mode for d in dec.ops if d.mux}

    # -- block autotune consumption -----------------------------------

    def _blocks(self, bucket: int) -> Dict[str, int]:
        if not (self.autotune_blocks and self.impl == "cuda"):
            return {}
        key = (bucket, self.table.version)
        with self._lock:
            hit = self._bcache.get(key)
        if hit is not None:
            return hit
        from repro_torch.kernels.fused_gnn import BLOCK_F_CANDIDATES
        from repro_torch.kernels.scatter_gather import BLOCK_COLS_CANDIDATES
        out = {}
        bf = best_block(self.table, "fused_gnn", "bf=",
                        BLOCK_F_CANDIDATES, bucket)
        if bf is not None:
            out["block_f"] = bf
        bc = best_block(self.table, "scatter_gather", "bc=",
                        BLOCK_COLS_CANDIDATES, bucket)
        if bc is not None:
            out["block_cols"] = bc
        with self._lock:
            self._bcache[key] = out
            for k in [k for k in self._bcache
                      if k[0] == bucket and k != key]:
                del self._bcache[k]
        return out

    # -- the per-batch entry point ------------------------------------

    def decide(self, avg_edges: float, bucket: int) -> DispatchDecision:
        measured = self._measured_assignment(bucket)
        cold = [s for s in self.sites if s not in measured]
        warm = None
        if cold:
            flop = self._flop_assignment(avg_edges)
            warm = self.warmup.next_mode(bucket)
            fallback_src = "warmup" if warm is not None else "flop"
            assignment = {s: measured.get(s, flop[s]) for s in self.sites}
            site_sources = {s: ("measured" if s in measured
                                else fallback_src) for s in self.sites}
            source = fallback_src
        else:
            assignment = dict(measured)
            site_sources = {s: "measured" for s in self.sites}
            source = "measured"
        with self._lock:
            self.decisions += 1
            self.source_counts[source] += 1
        return DispatchDecision(
            assignment=assignment, site_sources=site_sources,
            source=source, warm_mode=warm,
            blocks=self._blocks(bucket), bucket=bucket,
            avg_edges=float(avg_edges))

    def report(self) -> dict:
        with self._lock:
            counts = dict(self.source_counts)
            decisions = self.decisions
        return {"policy": "measured-cost", "impl": self.impl,
                "mux_sites": list(self.sites), "decisions": decisions,
                "sources": counts, "warmup": self.warmup.state(),
                "table_cells": len(self.table),
                "table_passes": self.table.passes}


__all__ = ["DispatchConfig", "DispatchDecision", "DispatchPolicy",
           "VariantCache", "variant_key", "SOURCES"]
