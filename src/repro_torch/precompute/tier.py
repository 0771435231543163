"""EmbeddingTier — the precomputed-embedding table with freshness.

A copy of ``repro.precompute.tier`` (numpy only): the table lives on the
host, and a lookup's rows join the batch's output on the device.

A compact [R, f_out] float32 table over the RESIDENT vertex set (whole
graph, or the top-degree prefix that fits ``budget_bytes``), plus:

  slot_of [V]   int32 vertex -> row (-1 = non-resident, permanently cold)
  fresh   [R]   per-vertex freshness bit — a lookup serves from the table
                only while set; a graph update clears it (demotion) and
                the vertex serves online until a refresh re-promotes it
  epoch   [R]   generation stamp taken at demote time; a refresh only
                re-promotes a vertex whose epoch is unchanged, so an
                update racing a refresh chunk always wins (the refreshed
                row was computed against the pre-update graph)

All methods are thread-safe: lookups run on scheduler stage threads,
demotions on the graph-update caller, promotions on refresh workers.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np


class EmbeddingTier:
    def __init__(self, num_vertices: int, f_out: int,
                 budget_bytes: Optional[int] = None,
                 degrees: Optional[np.ndarray] = None):
        row_bytes = f_out * 4
        if budget_bytes is not None \
                and budget_bytes < num_vertices * row_bytes:
            cap = max(0, budget_bytes // row_bytes)
            if cap and degrees is not None:
                # the budget goes to the top-degree vertices — the ones
                # Zipf traffic hits and the ones whose online fallback
                # (hub neighborhoods) is most expensive
                resident = np.sort(
                    np.argpartition(degrees, -cap)[-cap:])
            else:
                resident = np.arange(cap, dtype=np.int64)
        else:
            resident = np.arange(num_vertices, dtype=np.int64)
        self.num_vertices = num_vertices
        self.f_out = f_out
        self.resident_ids = resident.astype(np.int64)
        self.slot_of = np.full(num_vertices, -1, np.int32)
        self.slot_of[self.resident_ids] = np.arange(len(resident),
                                                    dtype=np.int32)
        self.table = np.zeros((len(resident), f_out), np.float32)
        self.fresh = np.zeros(len(resident), bool)
        self.epoch = np.zeros(len(resident), np.int64)
        self.generation = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.demotions = 0
        self.promotions = 0

    @property
    def capacity(self) -> int:
        return len(self.resident_ids)

    @property
    def nbytes(self) -> int:
        return int(self.table.nbytes)

    def install(self, ids: np.ndarray, rows: np.ndarray) -> int:
        """Unconditionally load rows (initial build / artifact load) and
        mark them fresh at the current generation."""
        with self._lock:
            slots = self.slot_of[np.asarray(ids, np.int64)]
            ok = slots >= 0
            self.table[slots[ok]] = rows[ok]
            self.fresh[slots[ok]] = True
            self.epoch[slots[ok]] = self.generation
            return int(ok.sum())

    def lookup(self, targets: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows [C, f_out], fresh_mask [C]) — rows are zero where the
        mask is False (those targets take the online path)."""
        targets = np.asarray(targets, np.int64)
        with self._lock:
            slots = self.slot_of[targets]
            resident = slots >= 0
            fresh = np.zeros(len(targets), bool)
            fresh[resident] = self.fresh[slots[resident]]
            rows = np.zeros((len(targets), self.f_out), np.float32)
            rows[fresh] = self.table[slots[fresh]]
            nf = int(fresh.sum())
            self.hits += nf
            self.misses += len(targets) - nf
        return rows, fresh

    def demote(self, vertices: np.ndarray) -> np.ndarray:
        """Clear freshness for the resident subset of ``vertices`` and
        stamp them with a new generation; returns the resident ids (the
        refresh backlog — already-stale vertices are included, their
        pending refresh must recompute against the newer graph)."""
        vertices = np.asarray(vertices, np.int64)
        with self._lock:
            slots = self.slot_of[vertices]
            ok = slots >= 0
            slots = slots[ok]
            self.generation += 1
            self.demotions += int(self.fresh[slots].sum())
            self.fresh[slots] = False
            self.epoch[slots] = self.generation
            return vertices[ok]

    def epoch_of(self, ids: np.ndarray) -> np.ndarray:
        with self._lock:
            return self.epoch[self.slot_of[np.asarray(ids, np.int64)]] \
                .copy()

    def promote(self, ids: np.ndarray, rows: np.ndarray,
                epochs: np.ndarray) -> int:
        """Install refreshed rows for vertices whose epoch is still
        ``epochs`` (captured when the refresh chunk was popped); a demote
        that landed mid-refresh bumps the epoch and the stale row is
        dropped (its re-enqueued backlog entry recomputes it)."""
        ids = np.asarray(ids, np.int64)
        with self._lock:
            slots = self.slot_of[ids]
            ok = (slots >= 0) & (self.epoch[np.maximum(slots, 0)]
                                 == epochs)
            self.table[slots[ok]] = rows[ok]
            self.fresh[slots[ok]] = True
            n = int(ok.sum())
            self.promotions += n
            return n

    def stats(self) -> dict:
        with self._lock:
            return {"resident": self.capacity,
                    "fresh": int(self.fresh.sum()),
                    "hits": self.hits, "misses": self.misses,
                    "demotions": self.demotions,
                    "promotions": self.promotions,
                    "tier_bytes": self.nbytes,
                    "generation": self.generation}
