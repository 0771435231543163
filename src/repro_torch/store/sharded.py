"""Sharded device feature store: the resident table partitioned across N
logical shards, with cross-shard gather and online PPR-mass rebalancing.

The PyTorch counterpart of ``repro.store.sharded``. ``DeviceFeatureStore``
(store/feature_store.py) keeps inference index-only while the feature
matrix fits ONE device's memory budget; past that, every cold row re-pays
the paper's t_load as a per-batch miss block. This store is the next step:

  * the resident table is split into ``num_shards`` shard tables, each a
    tensor on its own card when the host has that many (``shard_devices``;
    simulated shards, every table on the engine's device, otherwise), each
    under its OWN budget;
  * placement is ``hash`` (vertex id mod shards) or ``range`` (degree-rank
    bands: shard 0 holds the hottest band);
  * a batch ships, per shard, the int32 shard-local slot list of the unique
    rows it needs there; each shard gathers its rows on its own device
    (``index_select``), the blocks move to the target device and are
    concatenated and reordered there through one [C, N] int32 reorder map.
    Rows resident on no shard fall back to a host miss block, shipped at
    f_in like the single-device store's;
  * every lookup accumulates rank-weighted PPR mass per row, and ``repin()``
    rebuilds the residency from that observed mass (promoting hot rows,
    demoting dead ones, evening out skewed shards) without restarting the
    engine.

Placements are immutable snapshots keyed by a generation counter that rides
in the batch payload, so a ``repin()`` landing between a batch's host prep
and its device gather cannot mismap slots. The reference gathers with
``jnp.take`` (no Pallas kernel), so plain torch ops are the port.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_devices
from repro_torch.graphs.csr import CSRGraph
from repro_torch.store.feature_store import pad_feature_dim, to_device
from repro_torch.store.nbr_cache import as_vertex_ids
from repro_torch.store.policy import PLACEMENT_MODES as PLACEMENTS

BudgetSpec = Union[None, int, Sequence[int]]


@dataclass(frozen=True)
class ShardPlacement:
    """One immutable residency snapshot: which shard (if any) holds each
    vertex row, at which shard-local slot, and the shard tables built from
    that assignment. ``gen`` keys the snapshot in the payload."""
    gen: int
    shard_of: np.ndarray                # [V] int32, -1 = host partition
    slot_of: np.ndarray                 # [V] int32 shard-local slot, -1 = host
    tables: Tuple[torch.Tensor, ...]    # per shard [R_s, f_pad] on its device

    @property
    def resident_per_shard(self) -> Tuple[int, ...]:
        return tuple(int(t.shape[0]) for t in self.tables)

    @property
    def num_resident(self) -> int:
        return sum(self.resident_per_shard)

    @property
    def shard_bytes(self) -> List[int]:
        return [int(t.numel() * t.element_size()) for t in self.tables]


def _normalize_budgets(budget: BudgetSpec, num_shards: int,
                       total_rows: int, row_bytes: int) -> List[int]:
    """Per-shard row capacities. ``None`` = the whole matrix split evenly
    (full residency across the union of shards); an int applies to every
    shard; a sequence gives per-shard budgets (uneven shards)."""
    if budget is None:
        base = total_rows // num_shards
        extra = total_rows - base * num_shards
        return [base + (1 if s < extra else 0) for s in range(num_shards)]
    if isinstance(budget, (int, np.integer)):
        budgets = [int(budget)] * num_shards
    else:
        budgets = [int(b) for b in budget]
        if len(budgets) != num_shards:
            raise ValueError(f"{len(budgets)} shard budgets for "
                             f"{num_shards} shards")
    return [max(0, b // row_bytes) for b in budgets]


class ShardedFeatureStore:
    """Feature rows partitioned across shard-resident tables; batches ship
    per-shard slot lists + one reorder map (+ the host miss block).
    Implements the engine's feature-source interface."""

    name = "sharded"
    needs_host_feats = False

    def __init__(self, graph: CSRGraph, f_pad: int, device="cuda", *,
                 num_shards: int = 2, placement: str = "hash",
                 budget_bytes: BudgetSpec = None,
                 hot_scores: Optional[np.ndarray] = None):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if placement not in PLACEMENTS:
            raise ValueError(f"placement={placement!r}, expected one of "
                             f"{PLACEMENTS}")
        self.graph, self.f_pad = graph, f_pad
        self.num_shards = num_shards
        self.placement = placement
        v = graph.num_vertices
        self.row_bytes = f_pad * 4
        self.capacities = _normalize_budgets(budget_bytes, num_shards, v,
                                             self.row_bytes)
        score = np.asarray(graph.degrees if hot_scores is None
                           else hot_scores, np.float64)
        if len(score) != v:
            raise ValueError("hot_scores must have one entry per vertex")
        self.devices = shard_devices(num_shards, device)
        self.target_device = self.devices[0]
        self.simulated = len(set(self.devices)) < num_shards
        self._lock = threading.Lock()
        # online hotness: rank-weighted appearance mass per row (node lists
        # arrive PPR-rank-ordered)
        self._mass = np.zeros(v, np.float64)
        self._pad_row = torch.zeros((1, f_pad), dtype=torch.float32,
                                    device=self.target_device)
        self._placements: Dict[int, ShardPlacement] = {}
        # generation refcounts: host_payload takes a reference on its
        # snapshot, device_feats releases it; a placement is retired only
        # when it is no longer current AND no batch in flight points at it
        self._gen_refs: Dict[int, int] = {}
        self._gen = 0
        self._install(self._initial_assignment(score))
        # cumulative counters (under _lock)
        self.lookups = 0
        self.resident_lookups = 0
        self.miss_rows_shipped = 0
        self.cross_shard_rows = 0     # rows gathered off the target shard
        self.shard_lookups = np.zeros(num_shards, np.int64)
        self.repins = 0

    # payload keys are an instance attribute: they enumerate the shards
    @property
    def payload_keys(self) -> Tuple[str, ...]:
        return tuple(f"shard{s}_slots" for s in range(self.num_shards)) \
            + ("reorder", "miss_feats", "shard_gen")

    # -- placement construction ---------------------------------------------
    def _initial_assignment(self, score: np.ndarray) -> np.ndarray:
        """[V] int32 shard assignment (-1 = host) from the static policy.

        hash:  home shard = v mod num_shards; within a home bucket the top
               rows by ``score`` stay under that shard's capacity.
        range: vertices in descending-score order are cut into contiguous
               bands, one per shard, band s sized to capacity_s (shard 0
               holds the hottest band).
        """
        v = self.graph.num_vertices
        assign = np.full(v, -1, np.int32)
        if self.placement == "hash":
            home = (np.arange(v) % self.num_shards).astype(np.int32)
            for s in range(self.num_shards):
                mine = np.flatnonzero(home == s)
                k = min(len(mine), self.capacities[s])
                if k:
                    top = mine[np.argpartition(score[mine], -k)[-k:]]
                    assign[top] = s
        else:                                     # degree-range bands
            order = np.argsort(-score, kind="stable")
            lo = 0
            for s in range(self.num_shards):
                hi = min(v, lo + self.capacities[s])
                assign[order[lo:hi]] = s
                lo = hi
        return assign

    def _rows(self, ids: np.ndarray, device) -> torch.Tensor:
        """Feature rows of ``ids`` at f_pad as a tensor on ``device``."""
        rows = pad_feature_dim(self.graph.features[ids], self.f_pad)
        return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
            device)

    def _install(self, assign: np.ndarray) -> ShardPlacement:
        """Build shard tables + slot maps for ``assign`` and make it the
        current placement (a new generation)."""
        v = self.graph.num_vertices
        slot_of = np.full(v, -1, np.int32)
        tables = []
        for s in range(self.num_shards):
            ids = np.flatnonzero(assign == s)
            slot_of[ids] = np.arange(len(ids), dtype=np.int32)
            tables.append(self._rows(ids, self.devices[s]))
        with self._lock:
            self._gen += 1
            pl = ShardPlacement(self._gen, assign.astype(np.int32),
                                slot_of, tuple(tables))
            self._placements[pl.gen] = pl
            self._current = pl
            # retire snapshots nothing references anymore
            for g in [g for g in self._placements
                      if g != pl.gen and not self._gen_refs.get(g)]:
                del self._placements[g]
        return pl

    # -- feature-source interface -------------------------------------------
    def host_payload(self, node_lists, n, feats=None):
        with self._lock:                       # one snapshot per batch,
            pl = self._current                 # pinned until the gather
            self._gen_refs[pl.gen] = self._gen_refs.get(pl.gen, 0) + 1
        c = len(node_lists)
        ids = np.full((c, n), -1, np.int64)
        for i, nl in enumerate(node_lists):
            k = min(len(nl), n)
            ids[i, :k] = nl[:k]
        valid = ids >= 0
        flat = ids[valid]
        shard = pl.shard_of[flat]
        slot = pl.slot_of[flat]
        # reorder map into [pad_row | shard blocks ... | miss block]
        pos = np.zeros(len(flat), np.int64)
        payload: Dict[str, np.ndarray] = {}
        offset = 1                             # row 0 = zero pad row
        per_shard = np.zeros(self.num_shards, np.int64)
        for s in range(self.num_shards):
            sel = shard == s
            uniq, inv = np.unique(slot[sel], return_inverse=True)
            payload[f"shard{s}_slots"] = uniq.astype(np.int32)
            pos[sel] = offset + inv
            offset += len(uniq)
            per_shard[s] = int(sel.sum())
        miss_sel = shard < 0
        miss_ids, miss_inv = np.unique(flat[miss_sel], return_inverse=True)
        pos[miss_sel] = offset + miss_inv
        # the miss block ships at f_in: the shard tables carry the pad
        # columns, the link does not
        payload["miss_feats"] = self.graph.features[miss_ids] if \
            len(miss_ids) else np.zeros((0, self.graph.feature_dim),
                                        np.float32)
        reorder = np.zeros((c, n), np.int32)
        reorder[valid] = pos
        payload["reorder"] = reorder
        payload["shard_gen"] = np.asarray(pl.gen, np.int32)
        # rank-weighted PPR-mass accumulation: the O(C*N) reduction runs
        # outside the lock, only the O(unique) merge holds it
        w = (1.0 / (1.0 + np.arange(n, dtype=np.float64)))[None, :]
        uids, uinv = np.unique(flat, return_inverse=True)
        contrib = np.bincount(uinv,
                              weights=np.broadcast_to(w, ids.shape)[valid])
        with self._lock:
            self._mass[uids] += contrib
            self.lookups += int(valid.sum())
            self.resident_lookups += int(valid.sum() - miss_sel.sum())
            self.miss_rows_shipped += int(len(miss_ids))
            self.shard_lookups += per_shard
            self.cross_shard_rows += int(sum(
                len(payload[f"shard{s}_slots"])
                for s in range(1, self.num_shards)))
        return payload, None

    def device_feats(self, payload):
        gen = int(payload["shard_gen"])
        with self._lock:
            pl = self._placements[gen]
        try:
            target = self.target_device
            blocks = [self._pad_row]
            for s in range(self.num_shards):
                slots = payload[f"shard{s}_slots"]
                if slots.shape[0] == 0:
                    continue
                # shard-local gather: the slot list crosses to shard s
                # (int32, index only), the gathered rows cross back to the
                # target; on simulated shards both hops are no-ops
                sl = to_device(slots, self.devices[s]).long()
                blk = pl.tables[s].index_select(0, sl)
                blocks.append(blk.to(target, non_blocking=True))
            miss = payload["miss_feats"]
            if miss.shape[0]:
                blocks.append(pad_feature_dim(to_device(miss, target),
                                              self.f_pad))
            gathered = torch.cat(blocks, dim=0) if len(blocks) > 1 \
                else self._pad_row
            reorder = to_device(payload["reorder"], target).long()
            return gathered.index_select(0, reorder.reshape(-1)).reshape(
                *reorder.shape, self.f_pad)
        finally:
            with self._lock:
                r = self._gen_refs.get(gen, 0)
                if r > 1:
                    self._gen_refs[gen] = r - 1
                else:
                    self._gen_refs.pop(gen, None)
                    if gen != self._current.gen:
                        self._placements.pop(gen, None)

    # -- per-batch shard metrics (pure function of one payload) --------------
    def shard_metrics_for(self, payload) -> List[int]:
        """Host->device bytes this payload ships to each shard: the shard's
        slot list, plus (on the target shard) the reorder map and the miss
        block. Pure: safe from concurrent prepare threads."""
        out = [int(payload[f"shard{s}_slots"].nbytes)
               for s in range(self.num_shards)]
        out[0] += int(payload["reorder"].nbytes) \
            + int(payload["miss_feats"].nbytes)
        return out

    # -- online rebalancing ---------------------------------------------------
    def repin(self, decay: float = 0.0) -> dict:
        """Re-derive residency from the accumulated PPR mass: the globally
        hottest rows (by observed mass, degree as tiebreak for never-seen
        rows) fill the shard capacities. Rows keep their current shard when
        it still has room (minimizing table churn); the rest fill the free
        slots in proportion to each shard's free capacity. Returns a
        movement/balance report; ``decay`` scales the retained mass
        afterwards (0 keeps it all)."""
        with self._lock:
            mass = self._mass.copy()
            old = self._current
        deg = self.graph.degrees.astype(np.float64)
        key = mass + 1e-12 * deg
        total_cap = sum(self.capacities)
        v = self.graph.num_vertices
        k = min(v, total_cap)
        hot = np.argsort(-key, kind="stable")[:k] if k else \
            np.empty(0, np.int64)
        assign = np.full(v, -1, np.int32)
        free = np.array(self.capacities, np.int64)
        # pass 1: sticky — hot rows stay on their current shard
        cur = old.shard_of[hot]
        for s in range(self.num_shards):
            keep = hot[(cur == s)][:self.capacities[s]]
            assign[keep] = s
            free[s] -= len(keep)
        # pass 2: the remaining hot rows across the free slots, by stride
        # scheduling: shard s's k-th free slot sits at (k + 1) / free_s, and
        # filling slots in that order interleaves shards by free capacity
        pending = hot[assign[hot] < 0]
        slot_shard = np.repeat(np.arange(self.num_shards), np.maximum(
            free, 0))
        slot_pos = np.concatenate(
            [(np.arange(f) + 1.0) / f for f in free if f > 0]) \
            if (free > 0).any() else np.empty(0)
        order = np.argsort(slot_pos, kind="stable")
        take = min(len(pending), len(slot_shard))
        assign[pending[:take]] = slot_shard[order[:take]]
        promoted = int(((old.shard_of < 0) & (assign >= 0)).sum())
        demoted = int(((old.shard_of >= 0) & (assign < 0)).sum())
        moved = int(((old.shard_of >= 0) & (assign >= 0)
                     & (old.shard_of != assign)).sum())
        bal_before = self._balance(old, mass)
        pl = self._install(assign)
        bal_after = self._balance(pl, mass)
        with self._lock:
            self.repins += 1
            if decay:
                self._mass *= (1.0 - decay)
        return {"promoted": promoted, "demoted": demoted, "moved": moved,
                "resident_per_shard": pl.resident_per_shard,
                "mass_balance_before": bal_before,
                "mass_balance_after": bal_after}

    def _balance(self, pl: ShardPlacement, mass: np.ndarray) -> float:
        """max/mean of per-shard resident mass (1.0 = perfectly even)."""
        per = np.zeros(self.num_shards)
        res = pl.shard_of >= 0
        np.add.at(per, pl.shard_of[res], mass[res])
        mean = per.mean()
        return round(float(per.max() / mean), 4) if mean > 0 else 1.0

    # -- graph-update hook ----------------------------------------------------
    def refresh_features(self, vertices) -> int:
        """Re-upload the shard-resident rows of ``vertices`` from the
        (updated) host feature matrix. Host-partition rows need nothing:
        they ship fresh on every miss. The rows go into copies of the
        touched shard tables that replace the current generation's, so a
        gather already launched reads the tables as they were. Returns rows
        re-uploaded."""
        ids = as_vertex_ids(vertices)
        with self._lock:      # the swap is read-modify-write: concurrent
            pl = self._current    # invalidate() calls must not lose rows
            refreshed = 0
            tables = list(pl.tables)
            for s in range(self.num_shards):
                mine = ids[pl.shard_of[ids] == s]
                if not len(mine):
                    continue
                dev = self.devices[s]
                table = tables[s].clone()
                table[torch.from_numpy(pl.slot_of[mine].astype(np.int64))
                      .to(dev)] = self._rows(mine, dev)
                tables[s] = table
                refreshed += len(mine)
            if refreshed:
                new = ShardPlacement(pl.gen, pl.shard_of, pl.slot_of,
                                     tuple(tables))
                self._placements[pl.gen] = new
                self._current = new
        return refreshed

    # -- introspection --------------------------------------------------------
    @property
    def num_resident(self) -> int:
        return self._current.num_resident

    @property
    def resident_fraction(self) -> float:
        return self.num_resident / max(1, self.graph.num_vertices)

    @property
    def device_bytes(self) -> int:
        return sum(self._current.shard_bytes)

    def report(self) -> dict:
        with self._lock:
            pl = self._current
            lk, res, miss = (self.lookups, self.resident_lookups,
                             self.miss_rows_shipped)
            cross, repins = self.cross_shard_rows, self.repins
            per_lookups = self.shard_lookups.tolist()
            mass = self._mass.copy()
        per_rows = pl.resident_per_shard
        return {"strategy": self.name,
                "num_shards": self.num_shards,
                "placement": self.placement,
                "simulated": self.simulated,
                "devices": [str(d) for d in self.devices],
                "resident_rows": sum(per_rows),
                "resident_fraction": round(self.resident_fraction, 4),
                "device_bytes": sum(pl.shard_bytes),
                "shard_rows": list(per_rows),
                "shard_bytes": pl.shard_bytes,
                "shard_lookups": per_lookups,
                "shard_hit_share": [round(x / lk, 4) for x in per_lookups]
                if lk else [0.0] * self.num_shards,
                "mass_balance": self._balance(pl, mass),
                "lookups": lk,
                "resident_hit_rate": round(res / lk, 4) if lk else 0.0,
                "miss_rows_shipped": miss,
                "cross_shard_rows": cross,
                "repins": repins}


__all__ = ["ShardPlacement", "ShardedFeatureStore"]
