"""Host-side frontier-keyed caches: PPR neighborhoods + built subgraph rows.

INI (PPR local push) is the dominant host cost per target (paper t_pre,
Eq. 2), and induced-subgraph construction is the next (the Build stage of
the BatchPlan pipeline). Under skewed traffic the same targets recur, and
both artifacts are deterministic in ``(target, N, alpha, eps)`` — so both
cache under exactly that key:

  * ``NeighborhoodCache``  — per-target PPR node lists (Select stage).
  * ``SubgraphRowCache``   — the built per-target adjacency/edge rows
    (``core.subgraph.SubgraphRows``, Build stage): a hit skips induced-
    subgraph construction entirely, keyed alongside the neighborhood
    entry with the SAME generation/frontier-exact invalidation.

Entries for targets in the pinned hot set never evict; everything else is
LRU over ``capacity`` entries and, where ``max_bytes`` is set, over that
many bytes of cached values (a row counts the bytes it holds: its edge
arrays at their real edge count). ``invalidate(vertices)`` drops every cached
entry whose push FRONTIER (the full touched set, cached alongside the
value) contains an updated vertex — a graph update at v changes the PPR of
any target whose push reached v, even when v fell below that target's
top-N cutoff — forcing recompute on next lookup.

Thread-safe: the engine's stages run on the scheduler's stage workers, so
several batches may probe a cache concurrently. Two concurrent misses on
the same target may both compute (benign stampede); last put wins. A
computation in flight across an ``invalidate()`` must NOT insert its
(possibly pre-update) result: callers snapshot ``generation`` before
computing and pass it to ``put()``, which drops the insert when any
invalidation happened in between.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Iterable, Optional, Tuple

import numpy as np

Key = Tuple[int, int, float, float]       # (target, N, alpha, eps)


def nbr_key(target: int, n: int, alpha: float, eps: float) -> Key:
    return (int(target), int(n), float(alpha), float(eps))


def as_vertex_ids(vertices) -> np.ndarray:
    """Coerce a scalar, iterable, or array of vertex ids to unique sorted
    int64 — the shared normalization for both invalidation levels
    (neighborhood cache and device feature store)."""
    if not isinstance(vertices, np.ndarray):
        vertices = list(vertices) if np.iterable(vertices) else [vertices]
    return np.unique(np.asarray(vertices, dtype=np.int64))


class FrontierCache:
    """LRU + pinned-hot-set cache of per-target artifacts, each entry
    carrying its push's full touched frontier for exact invalidation.
    Subclasses pick the value type (``_freeze`` normalizes on insert and
    ``_footprint`` names the array invalidation scans when an entry has
    no frontier)."""

    def __init__(self, capacity: int = 4096,
                 pinned_targets: Optional[Iterable[int]] = None,
                 max_bytes: Optional[int] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.nbytes = 0                       # bytes of the cached values
        self._pin_ids = frozenset(
            int(t) for t in (() if pinned_targets is None
                             else pinned_targets))
        self._pinned: dict = {}               # never evicted
        self._lru: "OrderedDict[Hashable, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0                # entries dropped, not calls
        self._gen = 0                         # bumped by invalidate/clear

    # -- value hooks ---------------------------------------------------------
    def _freeze(self, value: Any) -> Any:
        """Normalize a value on insert (subclasses may copy/read-only it)."""
        return value

    def _footprint(self, value: Any) -> Optional[np.ndarray]:
        """Vertex ids invalidation scans when an entry has NO frontier
        (the pre-frontier approximation); None = always drop."""
        return None

    def _weigh(self, value: Any) -> int:
        """Bytes a value counts against ``max_bytes`` (0: not counted)."""
        return 0

    def _drop(self, ent) -> None:
        """Account an entry leaving the cache (called under the lock)."""
        self.nbytes -= self._weigh(ent[0])

    # -- core ----------------------------------------------------------------
    def get(self, key: Key) -> Optional[Any]:
        ent = self.get_entry(key)
        return None if ent is None else ent[0]

    def get_entry(self, key: Key) -> Optional[Tuple[Any, np.ndarray]]:
        """Like ``get`` but returns the full ``(value, frontier)`` entry —
        the Select stage hands a hit's frontier to the Build stage so a
        row-cache insert after a neighborhood hit stays frontier-exact."""
        with self._lock:
            ent = self._pinned.get(key)
            if ent is None:
                ent = self._lru.get(key)
                if ent is not None:
                    self._lru.move_to_end(key)
            if ent is None:
                self.misses += 1
                return None
            self.hits += 1
            return ent

    def put(self, key: Key, value: Any,
            generation: Optional[int] = None,
            frontier: Optional[np.ndarray] = None):
        """Insert a computed artifact. Pass the ``generation`` read BEFORE
        the computation started: if an invalidate() ran in between, the
        result may reflect the pre-update graph and is dropped (the next
        lookup recomputes). ``frontier`` is the push's full touched set
        (``select_important(with_frontier=True)``): with it, invalidation
        is EXACT; without it, invalidation falls back to scanning the
        value's footprint (approximate — updates at below-cutoff touched
        vertices go undetected)."""
        value = self._freeze(value)
        if frontier is not None:
            frontier = np.array(frontier)
            frontier.flags.writeable = False
        ent = (value, frontier)
        with self._lock:
            if generation is not None and generation != self._gen:
                return
            store = self._pinned if key[0] in self._pin_ids else self._lru
            old = store.get(key)
            if old is not None:
                self._drop(old)
            store[key] = ent
            self.nbytes += self._weigh(value)
            if store is self._pinned:
                return
            self._lru.move_to_end(key)
            while self._lru and (len(self._lru) > self.capacity or (
                    self.max_bytes is not None
                    and self.nbytes > self.max_bytes)):
                self._drop(self._lru.popitem(last=False)[1])
                self.evictions += 1

    def invalidate(self, vertices) -> int:
        """Drop every cached entry whose push FRONTIER contains any of
        ``vertices`` (pinned entries included). Returns the number of
        entries dropped.

        Entries stored with their full touched set are invalidated
        EXACTLY: an update at a vertex the push reached — even one below
        the top-N cutoff — drops the entry, because it can shift the
        target's scores enough to change its true top-N. Entries without
        a frontier (direct put() callers) fall back to scanning the
        value's footprint, the pre-frontier approximation."""
        vs = as_vertex_ids(vertices)

        def touched(ent) -> bool:
            scan = ent[1] if ent[1] is not None else self._footprint(ent[0])
            if scan is None:
                return True
            return bool(np.isin(scan, vs, assume_unique=False).any())

        # the O(entries * frontier) membership scan runs OUTSIDE the lock
        # so concurrent serving-path get/put calls don't stall behind a
        # graph update; the generation bump (taken first) keeps any
        # in-flight pre-update computation from landing afterwards
        with self._lock:
            self._gen += 1
            snapshot = [(store, list(store.items()))
                        for store in (self._pinned, self._lru)]
        stale = [(store, k, ent) for store, items in snapshot
                 for k, ent in items if touched(ent)]
        dropped = 0
        with self._lock:
            for store, k, ent in stale:
                # identity check: a fresh post-update recompute may have
                # replaced the entry while we scanned — keep that one
                if store.get(k) is ent:
                    del store[k]
                    self._drop(ent)
                    dropped += 1
            self.invalidations += dropped
        return dropped

    def clear(self):
        with self._lock:
            self._gen += 1
            self._pinned.clear()
            self._lru.clear()
            self.nbytes = 0

    @property
    def generation(self) -> int:
        """Invalidation epoch — snapshot before a miss's computation and
        hand to put()."""
        with self._lock:
            return self._gen

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._pinned) + len(self._lru)

    def __contains__(self, key: Key) -> bool:
        with self._lock:
            return key in self._pinned or key in self._lru

    @property
    def num_pinned_targets(self) -> int:
        """Size of the configured evict-exempt target set (not the number
        of pinned entries currently cached — see stats())."""
        return len(self._pin_ids)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._pinned) + len(self._lru),
                    "pinned_entries": len(self._pinned),
                    "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": round(self.hit_rate, 4),
                    "evictions": self.evictions,
                    "invalidations": self.invalidations}


class NeighborhoodCache(FrontierCache):
    """LRU + pinned-hot-set cache of per-target PPR node lists."""

    def _freeze(self, node_list: np.ndarray) -> np.ndarray:
        nl = np.array(node_list)              # copy: freezing an aliased
        nl.flags.writeable = False            # array would make the
        return nl                             # caller's list read-only

    def _footprint(self, node_list: np.ndarray) -> np.ndarray:
        # pre-frontier approximation: scan the truncated top-N selection
        return node_list


class SubgraphRowCache(FrontierCache):
    """LRU cache of built per-target subgraph rows (SubgraphRows): a hit
    skips the Build stage's induced-subgraph construction. Keyed by the
    same ``nbr_key`` as the neighborhood cache — the node list is
    deterministic in the key, so a neighborhood hit (or deterministic
    recompute) always corresponds to these rows — and invalidated by the
    same push frontier (the built rows only read vertices the push
    touched)."""

    def _freeze(self, rows):
        return rows.freeze()

    def _weigh(self, rows) -> int:
        return rows.nbytes

    def _footprint(self, rows) -> Optional[np.ndarray]:
        return None      # no node list stored: drop conservatively
