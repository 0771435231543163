"""Feature shipping strategies: how a batch's feature rows reach the device.

Three strategies share one interface (``host_payload`` on the host side of
the pipeline, ``device_feats`` on the device side), so the engine's
prepare/run_device stay strategy-agnostic:

  * ``DenseFeatureShipper``  — the baseline: every batch carries its own
    [C, N, f_pad] feature rows (the paper's t_load paid in full).
  * ``PackedFeatureShipper`` — cross-target dedup: unique rows once per
    batch plus an int32 index map, gathered on the device.
  * ``DeviceFeatureStore``   — rows resident in device memory from engine
    start; a batch ships an int32 slot map and the rows of the host
    partition it misses, and the device gathers them (``index_select``).

Host arrays cross to the device through a pinned host tensor and a
non-blocking copy on the current stream (``to_device``). The reference's
sharded store (``"sharded"``) is not ported yet and raises in
``build_feature_source``. All strategies emit feature rows padded to the
engine's feature width (``f_pad``), so padding is decided exactly once.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.csr import CSRGraph
from repro_torch.store.nbr_cache import as_vertex_ids


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: for a CUDA device through a
    pinned staging tensor and a non-blocking copy on the current stream
    (the caching host allocator keeps the staging buffer alive until the
    copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_feature_dim(feats, f_pad: int):
    """THE one feature-padding implementation: zero-pad the trailing dim
    to f_pad (exact, because the matching layer0 weight rows are zero).
    numpy arrays or torch tensors, any leading shape; no-op when already
    at f_pad."""
    pad = f_pad - feats.shape[-1]
    if pad == 0:
        return feats
    if pad < 0:
        raise ValueError(f"feature dim {feats.shape[-1]} exceeds "
                         f"f_pad={f_pad}")
    if isinstance(feats, torch.Tensor):
        return torch.nn.functional.pad(feats, (0, pad))
    widths = [(0, 0)] * (feats.ndim - 1) + [(0, pad)]
    return np.pad(feats, widths)


class DenseFeatureShipper:
    """Baseline: ship the dense [C, N, f_pad] block every batch."""

    name = "dense"
    needs_host_feats = True
    payload_keys = ("feats",)

    def __init__(self, graph: CSRGraph, f_pad: int, device):
        self.graph, self.f_pad = graph, f_pad
        self.device = torch.device(device)

    def host_payload(self, node_lists: List[np.ndarray], n: int,
                     feats: Optional[np.ndarray]
                     ) -> Tuple[Dict[str, np.ndarray], Optional[float]]:
        return {"feats": pad_feature_dim(feats, self.f_pad)}, None

    def device_feats(self, payload: Dict) -> torch.Tensor:
        return to_device(payload["feats"], self.device)

    def report(self) -> dict:
        return {"strategy": self.name}


class PackedFeatureShipper:
    """Cross-target dedup: unique rows [U, f] + int32 index map [C, N].

    PPR favors hubs, so the same vertices recur across a batch's subgraphs;
    each unique row crosses the link once and ``index_select`` rebuilds the
    [C, N, f] block on the device. ``ratio`` (packed/dense bytes) is
    surfaced per batch as the dedup ratio."""

    name = "packed"
    needs_host_feats = False
    payload_keys = ("uniq_feats", "feat_idx")

    def __init__(self, graph: CSRGraph, f_pad: int, device):
        self.graph, self.f_pad = graph, f_pad
        self.device = torch.device(device)

    def host_payload(self, node_lists, n, feats=None):
        from repro_torch.core.subgraph import packed_features
        uniq, idx, _ = packed_features(node_lists, self.graph, n)
        # ship at f_in — the device pads AFTER the gather (run_device's
        # pad_feature_dim), so the link never carries pad zeros. The
        # ratio denominator uses f_pad because that is what the dense
        # strategy ships
        ratio = (uniq.nbytes + idx.nbytes) / \
            (idx.shape[0] * idx.shape[1] * self.f_pad * 4)
        return {"uniq_feats": uniq, "feat_idx": idx}, ratio

    def device_feats(self, payload):
        uniq = to_device(payload["uniq_feats"], self.device)
        idx = to_device(payload["feat_idx"], self.device).long()
        return uniq.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, uniq.shape[-1])

    def report(self) -> dict:
        return {"strategy": self.name}


@dataclass(frozen=True)
class ResidencySnapshot:
    """One residency generation of the single-device store: which vertices
    are resident (1-based slot, -1 = host partition) and the device table
    built from that assignment. The generation rides in the batch payload
    so a ``repin()`` landing between a batch's host prep and its device
    gather cannot mismap slots."""
    gen: int
    slot_of: np.ndarray           # [V] int64, 1-based; -1 = host
    table: torch.Tensor           # [R + 1, f_pad] on the device; row 0 = 0
    num_resident: int


class DeviceFeatureStore:
    """Feature rows resident in device memory; batches ship slot maps.

    Layout: one device table [R + 1, f_pad]; slot 0 is the zero pad row
    (masked subgraph slots), slots 1..R are resident vertices. A batch's
    payload is a [C, N] int32 slot map plus a [M, f_in] miss block of
    host-partition rows (padded to f_pad on the device, so the link never
    carries pad zeros), addressed as slots R+1..R+M for that batch only.

    ``budget_bytes=None`` pins the whole matrix (full residency).
    Otherwise the top rows under the budget by ``hot_scores`` (default:
    degree) are resident and the rest stay host-side. Every lookup
    accumulates rank-weighted PPR mass per row (node lists arrive in PPR
    rank order, so 1/(1+rank) is the online estimate of the PPR score), and
    ``repin()`` re-derives the resident set from that observed mass.
    Residency lives in generational snapshots (the generation rides in the
    payload, counted per in-flight batch), so a repin never changes the
    table a batch in flight was planned against.
    """

    name = "resident"
    needs_host_feats = False
    payload_keys = ("feat_slots", "miss_feats", "store_gen")

    def __init__(self, graph: CSRGraph, f_pad: int, device, *,
                 budget_bytes: Optional[int] = None,
                 hot_scores: Optional[np.ndarray] = None):
        self.graph, self.f_pad = graph, f_pad
        self.device = torch.device(device)
        v = graph.num_vertices
        row_bytes = f_pad * 4
        if budget_bytes is None or budget_bytes >= (v + 1) * row_bytes:
            self.cap_rows = v                     # full residency
        else:
            self.cap_rows = min(v, max(0, budget_bytes // row_bytes - 1))
        score = np.asarray(graph.degrees if hot_scores is None
                           else hot_scores, np.float64)
        if len(score) != v:
            raise ValueError("hot_scores must have one entry per vertex")
        self._lock = threading.Lock()
        self._snapshots: Dict[int, ResidencySnapshot] = {}
        self._gen_refs: Dict[int, int] = {}
        self._gen = 0
        self._mass = np.zeros(v, np.float64)      # rank-weighted PPR mass
        self._install(self._top_rows(score))
        self.lookups = 0          # vertex slots resolved (excl. padding)
        self.resident_lookups = 0  # served from the device table
        self.miss_rows_shipped = 0  # host-partition rows shipped
        self.repins = 0

    def _top_rows(self, score: np.ndarray) -> np.ndarray:
        """Sorted ids of the ``cap_rows`` highest-scored vertices."""
        v, k = self.graph.num_vertices, self.cap_rows
        if k >= v:
            return np.arange(v, dtype=np.int64)
        return np.sort(np.argpartition(score, -k)[-k:]) if k \
            else np.empty(0, np.int64)

    def _install(self, resident_ids: np.ndarray) -> ResidencySnapshot:
        """Build the table + slot map for ``resident_ids`` and make it the
        current residency (a new generation)."""
        v = self.graph.num_vertices
        slot_of = np.full(v, -1, np.int64)
        slot_of[resident_ids] = np.arange(1, len(resident_ids) + 1)
        table = np.zeros((len(resident_ids) + 1, self.f_pad), np.float32)
        if len(resident_ids):
            table[1:] = pad_feature_dim(
                self.graph.features[resident_ids], self.f_pad)
        dev_table = torch.from_numpy(table).to(self.device)
        with self._lock:
            self._gen += 1
            snap = ResidencySnapshot(self._gen, slot_of, dev_table,
                                     int(len(resident_ids)))
            self._snapshots[snap.gen] = snap
            self._current = snap
            for g in [g for g in self._snapshots
                      if g != snap.gen and not self._gen_refs.get(g)]:
                del self._snapshots[g]
        return snap

    # residency state of the current generation
    @property
    def slot_of(self) -> np.ndarray:
        return self._current.slot_of

    @property
    def table(self) -> torch.Tensor:
        return self._current.table

    @property
    def num_resident(self) -> int:
        return self._current.num_resident

    @property
    def device_bytes(self) -> int:
        t = self._current.table
        return int(t.numel() * t.element_size())

    @property
    def resident_fraction(self) -> float:
        return self.num_resident / max(1, self.graph.num_vertices)

    def host_payload(self, node_lists, n, feats=None):
        # one snapshot per batch, held until the gather: the payload holds
        # a generation reference that device_feats releases (a payload that
        # is never gathered keeps its generation's table alive)
        with self._lock:
            snap = self._current
            self._gen_refs[snap.gen] = self._gen_refs.get(snap.gen, 0) + 1
        c = len(node_lists)
        ids = np.full((c, n), -1, np.int64)
        for i, nl in enumerate(node_lists):
            k = min(len(nl), n)
            ids[i, :k] = nl[:k]
        valid = ids >= 0
        slots = np.zeros((c, n), np.int64)
        slots[valid] = snap.slot_of[ids[valid]]
        missing = valid & (slots < 0)
        miss_ids = np.unique(ids[missing])
        if len(miss_ids):
            slots[missing] = snap.num_resident + 1 + \
                np.searchsorted(miss_ids, ids[missing])
            # the miss block ships at f_in and is padded on the device
            miss_feats = self.graph.features[miss_ids]
        else:
            miss_feats = np.zeros((0, self.graph.feature_dim), np.float32)
        # rank-weighted PPR-mass accumulation (node lists are ordered by
        # descending PPR score): the O(C*N) reduction runs outside the
        # lock, only the O(unique) merge holds it
        w = (1.0 / (1.0 + np.arange(n, dtype=np.float64)))[None, :]
        uids, uinv = np.unique(ids[valid], return_inverse=True)
        contrib = np.bincount(uinv,
                              weights=np.broadcast_to(w, ids.shape)[valid])
        with self._lock:
            self._mass[uids] += contrib
            self.lookups += int(valid.sum())
            self.resident_lookups += int(valid.sum() - missing.sum())
            self.miss_rows_shipped += int(len(miss_ids))
        return {"feat_slots": slots.astype(np.int32),
                "miss_feats": miss_feats,
                "store_gen": np.asarray(snap.gen, np.int32)}, None

    def device_feats(self, payload):
        gen = int(payload.get("store_gen", 0))
        with self._lock:
            snap = self._snapshots.get(gen, self._current)
        try:
            slots = to_device(payload["feat_slots"], self.device).long()
            r = snap.num_resident
            # two gathers and a select, not a concatenation (which would
            # copy the whole resident table every batch)
            res = snap.table.index_select(
                0, slots.clamp(0, r).reshape(-1)).reshape(
                    *slots.shape, self.f_pad)
            miss = payload["miss_feats"]
            if miss.shape[0] == 0:
                return res
            block = pad_feature_dim(to_device(miss, self.device), self.f_pad)
            mi = (slots - r - 1).clamp(0, miss.shape[0] - 1)
            m = block.index_select(0, mi.reshape(-1)).reshape(res.shape)
            return torch.where((slots > r)[..., None], m, res)
        finally:
            with self._lock:
                refs = self._gen_refs.get(gen, 0)
                if refs > 1:
                    self._gen_refs[gen] = refs - 1
                elif refs:
                    self._gen_refs.pop(gen, None)
                    if gen != self._current.gen:
                        self._snapshots.pop(gen, None)

    # -- online rebalancing ---------------------------------------------------
    def repin(self, decay: float = 0.0) -> dict:
        """Re-derive the resident set from the accumulated PPR mass: the
        hottest ``cap_rows`` rows by observed mass (degree as tiebreak for
        never-seen rows) become resident. Batches in flight keep their
        residency snapshot (the payload carries its generation), so serving
        never pauses. ``decay`` scales the retained mass afterwards (0
        keeps it all)."""
        with self._lock:
            mass = self._mass.copy()
            old = self._current
        key = mass + 1e-12 * self.graph.degrees.astype(np.float64)
        new_ids = self._top_rows(key)
        snap = self._install(new_ids)
        was = old.slot_of >= 0
        now = snap.slot_of >= 0
        promoted = int((~was & now).sum())
        demoted = int((was & ~now).sum())
        with self._lock:
            self.repins += 1
            if decay:
                self._mass *= (1.0 - decay)
        return {"promoted": promoted, "demoted": demoted,
                "resident_rows": snap.num_resident,
                "mass_covered": round(float(
                    mass[new_ids].sum() / mass.sum()), 4)
                if mass.sum() > 0 else 1.0}

    def refresh_features(self, vertices) -> int:
        """Re-upload the resident rows of ``vertices`` from the (updated)
        host feature matrix: the feature half of the graph-update hook.
        Host-partition vertices need nothing (their rows ship fresh from
        ``graph.features`` on every miss). The rows are written into a
        copy of the table that replaces the current generation's, so a
        gather already launched reads the table as it was, as the
        reference's immutable arrays do. Returns rows re-uploaded."""
        ids = as_vertex_ids(vertices)
        with self._lock:      # the swap is read-modify-write: concurrent
            snap = self._current  # invalidate() calls must not lose rows
            slots = snap.slot_of[ids]
            res = slots > 0
            if not res.any():
                return 0
            rows = pad_feature_dim(self.graph.features[ids[res]],
                                   self.f_pad)
            table = snap.table.clone()
            table[torch.from_numpy(slots[res]).to(self.device)] = \
                torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
            new = ResidencySnapshot(snap.gen, snap.slot_of, table,
                                    snap.num_resident)
            self._snapshots[snap.gen] = new
            self._current = new
        return int(res.sum())

    def report(self) -> dict:
        with self._lock:
            lk, res, miss = (self.lookups, self.resident_lookups,
                             self.miss_rows_shipped)
            repins = self.repins
        return {"strategy": self.name,
                "resident_rows": self.num_resident,
                "resident_fraction": round(self.resident_fraction, 4),
                "device_bytes": self.device_bytes,
                "lookups": lk,
                "resident_hit_rate": round(res / lk, 4) if lk else 0.0,
                "miss_rows_shipped": miss,
                "repins": repins}


def build_feature_source(graph: CSRGraph, policy, f_pad: int, device,
                         hot_scores: Optional[np.ndarray] = None):
    """Strategy factory keyed on ``StorePolicy.features``. ``hot_scores``
    defaults to the policy's own; vertex degree when neither is given."""
    if policy.features == "dense":
        return DenseFeatureShipper(graph, f_pad, device)
    if policy.features == "packed":
        return PackedFeatureShipper(graph, f_pad, device)
    if hot_scores is None and policy.hot_scores is not None:
        hot_scores = np.asarray(policy.hot_scores, np.float64)
    if policy.features == "resident":
        return DeviceFeatureStore(graph, f_pad, device,
                                  budget_bytes=policy.hbm_budget_bytes,
                                  hot_scores=hot_scores)
    if policy.features == "sharded":
        raise NotImplementedError(
            "StorePolicy.features='sharded': the sharded feature store is "
            "not ported to repro_torch yet (ROADMAP queue 1, item 7; use "
            "'dense', 'packed' or 'resident')")
    raise ValueError(f"unknown feature strategy {policy.features!r}")
