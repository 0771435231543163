"""Store policy: how an engine deployment caches features and neighborhoods.

The paper's end-to-end latency (Eq. 2) is t_pre + t_load + t_compute.
``StorePolicy`` picks, per deployment, how much of t_pre (PPR local push)
and t_load (host->device feature shipping) is traded for memory:

  features:  "dense"    ship [C, N, f] feature rows every batch (baseline)
             "packed"   cross-target dedup: unique rows + int32 index map
             "resident" device feature store: rows pinned in device memory
                        at engine start; batches ship int32 slot maps plus
                        only the rows that miss the HBM budget partition
             "sharded"  resident table partitioned across ``num_shards``
                        shard tables (one card each where the host has
                        enough, else simulated on the engine's device),
                        each under its own budget; batches ship per-shard
                        slot lists + a reorder map, rows gather
                        shard-locally, and ``repin()`` rebalances from
                        observed PPR mass (store/sharded.py)
  nbr_cache: "none"     re-run PPR local push per target every batch
             "lru"      LRU cache of per-target PPR node lists
             "pinned"   LRU plus a never-evicted hot set (top-degree
                        targets by default, or an explicit pin list)

  subgraph_rows: "auto" cache the BUILT per-target adjacency/edge rows
                        (SubgraphRowCache) whenever a neighborhood cache
                        is configured — a hit skips the Build stage's
                        induced-subgraph construction entirely
                 "on" | "off"  force it either way (rows are ~N^2 floats
                        per target — "off" trades Build time for memory)

  repin_every / repin_hit_floor: automatic residency rebalance triggers
    (resident/sharded features only) — the pipeline's completion path
    calls ``engine.repin()`` every K completed batches, or whenever the
    store's resident hit rate since the last repin drops below the floor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

FEATURE_MODES = ("dense", "packed", "resident", "sharded")
NBR_CACHE_MODES = ("none", "lru", "pinned")
PLACEMENT_MODES = ("hash", "range")
SUBGRAPH_ROW_MODES = ("auto", "on", "off")
REPINNABLE_FEATURES = ("resident", "sharded")


@dataclass(frozen=True)
class StorePolicy:
    """Per-deployment caching configuration (see module docstring)."""
    features: str = "dense"
    hbm_budget_bytes: Optional[int] = None   # resident: None = whole matrix
    # per-vertex residency score (array-like [V], e.g. accumulated PPR
    # mass; None = vertex degree); compare=False keeps the frozen
    # dataclass's ==/hash usable when an ndarray is supplied
    hot_scores: Optional[object] = field(default=None, compare=False)
    # sharded-store knobs (features="sharded" only)
    num_shards: int = 0                      # logical shards (>= 1)
    placement: str = "hash"                  # hash | range (degree bands)
    # per-shard HBM budget: None = whole matrix split across shards, an
    # int applies to every shard, a tuple gives uneven per-shard budgets
    shard_budget_bytes: Optional[object] = field(default=None,
                                                 compare=False)
    nbr_cache: str = "none"
    nbr_capacity: int = 4096                 # LRU entries (excludes pins)
    pinned_targets: Optional[Tuple[int, ...]] = None
    pinned_count: int = 0                    # auto-pin top-degree targets
    # Build-stage subgraph-row cache: "auto" follows nbr_cache (rows are
    # cached whenever neighborhoods are), "on"/"off" force it
    subgraph_rows: str = "auto"
    # explicit entry cap; None = bounded by the byte budget below, each
    # entry counted at its bytes (~2N^2 floats + its edge arrays at the
    # real edge count: far heavier than a node list), and at nbr_capacity
    # entries
    subgraph_capacity: Optional[int] = None
    subgraph_budget_bytes: int = 256 << 20
    # automatic residency rebalance (resident/sharded features): repin
    # every K completed batches, and/or when the store's resident hit
    # rate since the last repin falls below the floor (0 = off for both)
    repin_every: int = 0
    repin_hit_floor: float = 0.0

    def __post_init__(self):
        if self.features not in FEATURE_MODES:
            raise ValueError(
                f"features={self.features!r}, expected one of {FEATURE_MODES}")
        if self.nbr_cache not in NBR_CACHE_MODES:
            raise ValueError(f"nbr_cache={self.nbr_cache!r}, "
                             f"expected one of {NBR_CACHE_MODES}")
        if self.placement not in PLACEMENT_MODES:
            raise ValueError(f"placement={self.placement!r}, "
                             f"expected one of {PLACEMENT_MODES}")
        if self.nbr_capacity < 1:
            raise ValueError("nbr_capacity must be >= 1")
        if self.pinned_count < 0:
            raise ValueError("pinned_count must be >= 0")
        if (self.pinned_targets is not None or self.pinned_count) \
                and self.nbr_cache != "pinned":
            raise ValueError("pinned_targets/pinned_count require "
                             "nbr_cache='pinned'")
        if self.hbm_budget_bytes is not None \
                and self.features != "resident":
            raise ValueError("hbm_budget_bytes requires features='resident'"
                             " (sharded stores use shard_budget_bytes)")
        if self.hot_scores is not None \
                and self.features not in ("resident", "sharded"):
            raise ValueError("hot_scores require features='resident' "
                             "or 'sharded'")
        if self.features == "sharded":
            if self.num_shards < 1:
                raise ValueError("features='sharded' needs num_shards >= 1")
        elif self.num_shards or self.shard_budget_bytes is not None:
            raise ValueError("num_shards/shard_budget_bytes require "
                             "features='sharded'")
        if self.subgraph_rows not in SUBGRAPH_ROW_MODES:
            raise ValueError(f"subgraph_rows={self.subgraph_rows!r}, "
                             f"expected one of {SUBGRAPH_ROW_MODES}")
        if self.subgraph_capacity is not None \
                and self.subgraph_capacity < 1:
            raise ValueError("subgraph_capacity must be >= 1")
        if self.subgraph_budget_bytes < 1:
            raise ValueError("subgraph_budget_bytes must be >= 1")
        if self.repin_every < 0:
            raise ValueError("repin_every must be >= 0")
        if not 0.0 <= self.repin_hit_floor <= 1.0:
            raise ValueError("repin_hit_floor must be in [0, 1]")
        if (self.repin_every or self.repin_hit_floor) \
                and self.features not in REPINNABLE_FEATURES:
            raise ValueError(
                "repin_every/repin_hit_floor require features in "
                f"{REPINNABLE_FEATURES} (got {self.features!r})")

    @property
    def cache_subgraph_rows(self) -> bool:
        """Resolved Build-cache switch: "auto" mirrors the neighborhood
        cache (hot traffic that re-selects also re-builds)."""
        if self.subgraph_rows == "auto":
            return self.nbr_cache != "none"
        return self.subgraph_rows == "on"

    def describe(self) -> dict:
        if self.pinned_targets is not None:
            pins = len(self.pinned_targets)
        elif self.pinned_count:
            pins = self.pinned_count
        else:
            # the engine resolves "auto" to a concrete top-degree pin set
            # and overwrites this field in store_report()
            pins = "auto" if self.nbr_cache == "pinned" else 0
        d = {"features": self.features,
             "hbm_budget_bytes": self.hbm_budget_bytes,
             "nbr_cache": self.nbr_cache,
             "nbr_capacity": self.nbr_capacity,
             "pinned_count": pins,
             "subgraph_rows": self.cache_subgraph_rows}
        if self.repin_every or self.repin_hit_floor:
            d.update(repin_every=self.repin_every,
                     repin_hit_floor=self.repin_hit_floor)
        if self.features == "sharded":
            b = self.shard_budget_bytes
            d.update(num_shards=self.num_shards, placement=self.placement,
                     shard_budget_bytes=list(b) if b is not None
                     and not isinstance(b, int) else b)
        return d
