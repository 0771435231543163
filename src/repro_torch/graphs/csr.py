"""CSR graph store (numpy, host-side — the paper keeps the graph in host
memory and only ships per-target induced subgraphs to the accelerator).

The store is directed CSR over out-edges; GNN datasets are symmetrized at
construction. Features live alongside as a dense [V, f] float32 matrix.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray            # [V+1] int64
    indices: np.ndarray           # [E] int32
    features: np.ndarray          # [V, f] float32
    labels: Optional[np.ndarray] = None   # [V] int32
    name: str = "graph"
    # update listeners: called with the affected vertex ids after every
    # apply_edge_updates (DecoupledEngine registers its invalidate hook
    # here, so cached neighborhoods / resident feature rows stay coherent
    # with the mutating graph)
    _listeners: List[Callable] = field(default_factory=list, repr=False)

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def validate(self):
        assert self.indptr[0] == 0 and self.indptr[-1] == self.num_edges
        assert np.all(np.diff(self.indptr) >= 0)
        if self.num_edges:
            assert self.indices.min() >= 0
            assert self.indices.max() < self.num_vertices
        assert self.features.shape[0] == self.num_vertices
        return self

    def __deepcopy__(self, memo):
        """Listeners are deployment wiring (live engines holding locks),
        not graph data — a copied graph starts with none."""
        import copy
        return CSRGraph(indptr=copy.deepcopy(self.indptr, memo),
                        indices=copy.deepcopy(self.indices, memo),
                        features=copy.deepcopy(self.features, memo),
                        labels=copy.deepcopy(self.labels, memo),
                        name=self.name)

    # -- graph-update streaming (ROADMAP: edge insert/delete batches) -------
    def register_listener(self, fn: Callable) -> None:
        """``fn(affected_vertices)`` runs after every apply_edge_updates.
        Holds a strong reference — pair with unregister_listener (the
        engine does both in __init__/close)."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def unregister_listener(self, fn: Callable) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def apply_edge_updates(self, insert=None, delete=None,
                           symmetrize: bool = True) -> np.ndarray:
        """Apply a batch of edge inserts/deletes in place and notify
        listeners (e.g. ``DecoupledEngine.invalidate``) with the affected
        vertex ids.

        ``insert``/``delete``: an iterable of ``(u, v)`` pairs, or a
        ``(src_array, dst_array)`` tuple of numpy arrays, in GLOBAL
        vertex ids. With ``symmetrize`` (the
        dataset default) each update applies in both directions; self
        loops are dropped (layers add their own normalized self terms),
        duplicates dedup. Vertices cannot be added — ids must be < V.
        Rebuilds ``indptr``/``indices`` (degrees update with them) and
        returns the sorted unique affected vertex ids.

        Concurrency: the two CSR arrays swap in one C-level dict.update,
        so a concurrent reader never sees the torn new-indptr/old-indices
        state; a reader that loaded one array before the swap and the
        other after can still pair mismatched snapshots. Batches already
        in flight were prepared against the pre-update graph either way —
        the cache generation mechanism (NeighborhoodCache.put) keeps
        their stale results out of the caches, and the next lookup
        recomputes on the mutated CSR."""
        def _pairs(x):
            if x is None:
                return (np.zeros(0, np.int64),) * 2
            # the array form is recognized ONLY by ndarray elements —
            # a tuple of two (u, v) pairs must parse as two edges, not
            # as (src, dst) columns
            if isinstance(x, tuple) and len(x) == 2 \
                    and isinstance(x[0], np.ndarray):
                s, d = (np.asarray(x[0], np.int64),
                        np.asarray(x[1], np.int64))
            else:
                arr = np.asarray(list(x), np.int64).reshape(-1, 2)
                s, d = arr[:, 0], arr[:, 1]
            if len(s) and (min(s.min(), d.min()) < 0
                           or max(s.max(), d.max()) >= self.num_vertices):
                raise ValueError("edge update references vertex id outside "
                                 f"[0, {self.num_vertices})")
            return s, d

        ins_s, ins_d = _pairs(insert)
        del_s, del_d = _pairs(delete)
        if symmetrize:
            ins_s, ins_d = (np.concatenate([ins_s, ins_d]),
                            np.concatenate([ins_d, ins_s]))
            del_s, del_d = (np.concatenate([del_s, del_d]),
                            np.concatenate([del_d, del_s]))
        keep = ins_s != ins_d                          # no self loops
        ins_s, ins_d = ins_s[keep], ins_d[keep]

        v = self.num_vertices
        cur_s = np.repeat(np.arange(v, dtype=np.int64), self.degrees)
        cur_d = self.indices.astype(np.int64)
        cur_key = cur_s * v + cur_d
        if len(del_s):
            cur_key = cur_key[~np.isin(cur_key, del_s * v + del_d)]
        if len(ins_s):
            cur_key = np.concatenate([cur_key, ins_s * v + ins_d])
        cur_key = np.unique(cur_key)                   # dedup + sort
        new_s, new_d = cur_key // v, cur_key % v
        counts = np.bincount(new_s, minlength=v)
        indptr = np.zeros(v + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        # single C-level update: no window where a reader can observe the
        # new indptr paired with the old (shorter) indices array
        self.__dict__.update(indptr=indptr,
                             indices=new_d.astype(np.int32))
        self.validate()
        affected = np.unique(np.concatenate([ins_s, ins_d, del_s, del_d]))
        for fn in list(self._listeners):
            fn(affected)
        return affected


def from_edge_list(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                   features: np.ndarray, symmetrize: bool = True,
                   labels=None, name: str = "graph") -> CSRGraph:
    """Build CSR from (src, dst) arrays; dedups; optionally symmetrizes."""
    if symmetrize:
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
    # drop self loops (GNN layers add their own normalized self terms)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # dedup via sort on (src, dst)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if len(src):
        uniq = np.concatenate([[True], (np.diff(src) != 0)
                               | (np.diff(dst) != 0)])
        src, dst = src[uniq], dst[uniq]
    counts = np.bincount(src, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32),
                    features=features, labels=labels, name=name).validate()


def subgraph_edges(g: CSRGraph, nodes: np.ndarray):
    """Induced-subgraph edge list in *local* indices.

    nodes: [n] unique global vertex ids; local id = position in ``nodes``.
    Returns (src_local [e], dst_local [e]) int32.
    """
    n = len(nodes)
    local = {}
    # vectorized mapping: global -> local via searchsorted on sorted nodes
    order = np.argsort(nodes)
    sorted_nodes = nodes[order]
    starts = g.indptr[nodes]
    ends = g.indptr[nodes + 1]
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    # gather all out-edges of `nodes`
    src_rep = np.repeat(np.arange(n, dtype=np.int32), counts)
    idx = np.concatenate([g.indices[s:e] for s, e in zip(starts, ends)]) \
        if n < 4096 else _gather_ranges(g.indices, starts, ends, total)
    # keep edges whose head is inside the node set
    pos = np.searchsorted(sorted_nodes, idx)
    pos = np.clip(pos, 0, n - 1)
    inside = sorted_nodes[pos] == idx
    dst_local = order[pos[inside]].astype(np.int32)
    src_local = src_rep[inside]
    del local
    return src_local, dst_local


def _gather_ranges(arr, starts, ends, total):
    out = np.empty(total, arr.dtype)
    o = 0
    for s, e in zip(starts, ends):
        ln = e - s
        out[o:o + ln] = arr[s:e]
        o += ln
    return out
