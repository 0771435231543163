"""Vertex-induced subgraph construction and fixed-shape padded batches.

The paper ships, per target vertex, the induced subgraph over its N
important neighbors: vertex features [N, f] plus edges. Shapes are FIXED by
the model's receptive-field size N (the decoupling property), which is what
lets the accelerator use static buffers — and here, what lets jit compile
once per (model, N, C) and never again.

Two device layouts are produced (the two ACK execution modes):
  * dense:  adj [C, N, N] float32 — normalized adjacency (+ self loops for
    GCN-style aggregation): aggregation runs as a batched matmul.
  * edges:  (src, dst, w) int32/float32 padded to E_max — the faithful
    scatter-gather layout for the sparse-mode kernel.

The per-target build artifact is ``SubgraphRows`` — every structure array
one target's subgraph contributes to the batch, and the unit the Build
stage caches (store.nbr_cache.SubgraphRowCache): a neighborhood-cache hit
whose rows are also cached skips induced-subgraph construction entirely.
The sg-mode edge extras (``self_w``, ``edge_w_mean``) are computed here
directly from the CSR edge lists — not recovered per batch by densifying
``adj`` — and carried on ``SubgraphBatch``.

No edge is ever dropped. A given ``e_pad`` is an edge budget: a subgraph
with more edges than it is refused (``EdgeBudgetError``, counted in
``edges_refused``), never cut. Rows hold every edge, at their real edge
count, and a batch lays its edges out in only as many slots as its largest
subgraph needs (``edge_slots``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.ini import ini_batch
from repro_torch.graphs.csr import CSRGraph, subgraph_edges

# a batch's edge slots are its largest subgraph's edge count rounded up to
# a multiple of this (so a deployment's batches take a few shapes)
EDGE_SLOT_QUANTUM = 1024

# subgraphs refused for exceeding their edge budget, and their edges
# (``check_edge_budget``); a correct deployment keeps both at 0
edges_refused = 0
subgraphs_refused = 0
_refused_lock = threading.Lock()


class EdgeBudgetError(ValueError):
    """A subgraph has more edges than its edge budget (``e_pad``): the
    program refuses it rather than drop edges."""


def check_edge_budget(n_edges: int, e_pad: Optional[int]) -> None:
    """Raise ``EdgeBudgetError`` (and count the refusal) when a subgraph's
    ``n_edges`` exceed the budget ``e_pad``; None is no budget."""
    global edges_refused, subgraphs_refused
    if e_pad is None or n_edges <= e_pad:
        return
    with _refused_lock:
        edges_refused += int(n_edges)
        subgraphs_refused += 1
    raise EdgeBudgetError(
        f"a subgraph has {n_edges} edges, over the edge budget e_pad="
        f"{e_pad}; raise ServingConfig.e_pad (on the engine and its graph "
        f"hosts; N(N-1) holds any subgraph) to serve it")


def edge_slots(n_edges, e_pad: Optional[int]) -> int:
    """Edge slots a batch whose subgraphs have ``n_edges`` real edges is
    laid out in: the largest rounded up to a multiple of
    ``EDGE_SLOT_QUANTUM``, never above the budget ``e_pad`` (refused over
    it, ``check_edge_budget``)."""
    most = int(max(n_edges, default=0))
    check_edge_budget(most, e_pad)
    slots = max(1, -(-most // EDGE_SLOT_QUANTUM)) * EDGE_SLOT_QUANTUM
    return slots if e_pad is None else min(slots, int(e_pad))


@dataclass(frozen=True)
class SubgraphRows:
    """One target's built subgraph structure, padded to n_pad vertices,
    its edge arrays at the real edge count (the Build stage's output and
    cache value): everything ``build_subgraph`` produces except features.
    ``edges_dropped`` is always 0 here (the field stays for the wire,
    whose rows a graph host that cuts edges fills; ``rows_from_wire``
    refuses them)."""
    adj: np.ndarray          # [n, n]  float32, normalized, row=dst
    adj_mean: np.ndarray     # [n, n]  row-stochastic (no self loops)
    mask: np.ndarray         # [n]     float32 (1 = real vertex)
    edge_src: np.ndarray     # [e]     int32 (padded with -> dummy vertex)
    edge_dst: np.ndarray     # [e]     int32
    edge_w: np.ndarray       # [e]     float32 (0 on padding)
    self_w: np.ndarray       # [n]     float32 self-loop weight (adj diag)
    edge_w_mean: np.ndarray  # [e]     float32 row-stochastic edge weight
    n_vertices: int
    n_edges: int
    edges_dropped: int

    def freeze(self) -> "SubgraphRows":
        """Mark every array read-only (cache entries are shared across
        batches — assemble copies them into the batch tensors)."""
        for a in (self.adj, self.adj_mean, self.mask, self.edge_src,
                  self.edge_dst, self.edge_w, self.self_w,
                  self.edge_w_mean):
            a.flags.writeable = False
        return self

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in (
            self.adj, self.adj_mean, self.mask, self.edge_src,
            self.edge_dst, self.edge_w, self.self_w, self.edge_w_mean))


@dataclass(frozen=True)
class SubgraphBatch:
    """Host-side padded batch for C target vertices (all numpy)."""
    feats: np.ndarray        # [C, N, f]  float32
    adj: np.ndarray          # [C, N, N]  float32, normalized, row=dst
    adj_mean: np.ndarray     # [C, N, N]  row-stochastic (no self loops)
    mask: np.ndarray         # [C, N]     float32 (1 = real vertex)
    edge_src: np.ndarray     # [C, E]     int32 (padded with E -> dummy)
    edge_dst: np.ndarray     # [C, E]     int32
    edge_w: np.ndarray       # [C, E]     float32 (0 on padding)
    n_vertices: np.ndarray   # [C]        int32
    n_edges: np.ndarray      # [C]        int32
    targets: np.ndarray      # [C]        int64 global ids
    edges_dropped: int = 0   # always 0: over-budget subgraphs are refused
    # sg-mode edge extras, carried from the Build stage (computed from the
    # CSR edge lists — None only for externally constructed batches, where
    # consumers fall back to recovering them from the dense adjacency)
    self_w: Optional[np.ndarray] = None       # [C, N] float32
    edge_w_mean: Optional[np.ndarray] = None  # [C, E] float32

    @property
    def batch_size(self) -> int:
        return self.feats.shape[0]

    @property
    def n(self) -> int:
        return self.feats.shape[1]

    def device_arrays(self, mode: str = "dense") -> Dict[str, np.ndarray]:
        """The arrays actually shipped host->device (PCIe analogue)."""
        if mode == "dense":
            return {"feats": self.feats, "adj": self.adj,
                    "adj_mean": self.adj_mean, "mask": self.mask}
        return {"feats": self.feats, "mask": self.mask,
                "edge_src": self.edge_src, "edge_dst": self.edge_dst,
                "edge_w": self.edge_w}

    def nbytes(self, mode: str = "dense") -> int:
        return sum(a.nbytes for a in self.device_arrays(mode).values())


def build_subgraph_rows(g: CSRGraph, nodes: np.ndarray, n_pad: int,
                        e_pad: Optional[int] = None) -> SubgraphRows:
    """One induced subgraph's structure arrays, padded to n_pad vertices,
    its edge arrays at the real edge count — no feature materialization
    (features are the store's concern, and caching built rows must not pin
    feature blocks). ``e_pad`` is the edge budget: a subgraph over it
    raises ``EdgeBudgetError`` (every edge is kept or the subgraph
    refused).
    """
    k = len(nodes)
    assert k <= n_pad
    src, dst = subgraph_edges(g, nodes)
    e = len(src)
    check_edge_budget(e, e_pad)
    # normalized GCN adjacency with self loops: A_hat[d, s] = 1/sqrt(dd*ds)
    deg = np.ones(k, np.float64)                    # self loop counts as 1
    np.add.at(deg, dst, 1.0)
    inv_sqrt = 1.0 / np.sqrt(deg)
    adj = np.zeros((n_pad, n_pad), np.float32)
    adj[dst, src] = (inv_sqrt[dst] * inv_sqrt[src]).astype(np.float32)
    idx = np.arange(k)
    self_w = np.zeros(n_pad, np.float32)
    self_w[:k] = (inv_sqrt * inv_sqrt).astype(np.float32)
    adj[idx, idx] = self_w[:k]
    # row-stochastic mean adjacency (neighbors only; SAGE-style)
    adj_mean = np.zeros((n_pad, n_pad), np.float32)
    indeg = np.zeros(k, np.float64)
    np.add.at(indeg, dst, 1.0)
    nz = indeg[dst] > 0
    adj_mean[dst[nz], src[nz]] = (1.0 / indeg[dst[nz]]).astype(np.float32)
    mask = np.zeros(n_pad, np.float32)
    mask[:k] = 1.0
    es, ed = src.astype(np.int32), dst.astype(np.int32)
    ew = adj[dst, src]
    # sg-mode mean weights straight from the in-degree counts: float32
    # division of exact integer counts, bitwise what densifying adj_mean
    # and re-counting nonzeros used to produce
    inv_indeg = 1.0 / np.maximum(indeg, 1.0).astype(np.float32)
    ew_mean = np.where(ew != 0, inv_indeg[dst], 0.0).astype(np.float32)
    return SubgraphRows(adj=adj, adj_mean=adj_mean, mask=mask,
                        edge_src=es, edge_dst=ed, edge_w=ew,
                        self_w=self_w, edge_w_mean=ew_mean,
                        n_vertices=k, n_edges=e, edges_dropped=0)


def build_subgraph(g: CSRGraph, nodes: np.ndarray, n_pad: int,
                   e_pad: Optional[int] = None, with_feats: bool = True):
    """One induced subgraph, padded to n_pad vertices and its edges to
    e_pad slots (without a budget, max(1, edges)) — the one-call
    back-compat spelling over ``build_subgraph_rows``.

    ``with_feats=False`` skips host-side feature materialization entirely
    (feats comes back [n_pad, 0]) — used when a feature-store strategy
    ships indices instead, so the dense block is never allocated."""
    r = build_subgraph_rows(g, nodes, n_pad, e_pad)
    feats = np.zeros((n_pad, g.feature_dim if with_feats else 0),
                     np.float32)
    if with_feats:
        feats[:len(nodes)] = g.features[nodes]
    es, ed, ew, _ = (a[0] for a in edge_layout(
        [r], n_pad, max(1, r.n_edges) if e_pad is None else e_pad))
    return (feats, r.adj, r.adj_mean, r.mask, es, ed, ew, r.n_vertices,
            r.n_edges, r.edges_dropped)


def default_edge_pad(g: CSRGraph, n: int) -> int:
    """The edge layout where no budget is configured: 4x N*avg_degree,
    capped at the complete graph (PPR-selected neighborhoods are *dense*:
    hubs select hubs), rounded up to 128 slots. It sizes the DSE's
    scatter-gather plan and the wire's row layout; it is no budget: until
    edges were refused instead of cut, an sg subgraph over it lost its
    extra edges silently. A configured ``ServingConfig.e_pad`` is a budget
    (refused over it); N(N-1) is the one no subgraph exceeds, and costs no
    padding, since a batch is laid out in its largest subgraph's edges
    (``edge_slots``)."""
    e = int(4 * n * max(4.0, float(g.degrees.mean())))
    e = min(e, n * (n - 1))
    return max(128, e + (-e) % 128)


def packed_features(node_lists: List[np.ndarray], g: CSRGraph, n: int):
    """Cross-target feature dedup (beyond-paper): PPR favors hubs, so the
    same vertices recur across a batch's subgraphs. Ship each unique row
    ONCE (uniq [U, f]) plus an int32 index map [C, n]; the device
    reconstructs feats = uniq[idx]. Returns (uniq, idx, ratio) where ratio
    = packed bytes / dense bytes (< 1 means savings on the host->device
    link — the paper's t_load, Eq. 2)."""
    C = len(node_lists)
    idx = np.zeros((C, n), np.int32)
    all_ids = np.concatenate([nl[:n] for nl in node_lists])
    uniq_ids, inv = np.unique(all_ids, return_inverse=True)
    # row 0 of uniq is a zero pad row for masked slots
    uniq = np.zeros((len(uniq_ids) + 1, g.feature_dim), np.float32)
    uniq[1:] = g.features[uniq_ids]
    o = 0
    for i, nl in enumerate(node_lists):
        k = min(len(nl), n)
        idx[i, :k] = inv[o:o + k] + 1
        o += k
    dense_bytes = C * n * g.feature_dim * 4
    packed_bytes = uniq.nbytes + idx.nbytes
    return uniq, idx, packed_bytes / dense_bytes


def build_batch(g: CSRGraph, targets, n: int, e_pad: Optional[int] = None,
                num_threads: int = 8, alpha: float = 0.15,
                eps: float = 1e-4) -> SubgraphBatch:
    """INI + induced-subgraph build for a batch of targets (host side).
    ``e_pad`` is the edge budget (None: none); the batch's edge slots
    follow its largest subgraph (``edge_slots``)."""
    node_lists = ini_batch(g, targets, n, alpha, eps, num_threads)
    rows = [build_subgraph_rows(g, nl[:n], n, e_pad) for nl in node_lists]
    return assemble_batch(g, targets, node_lists, rows, n,
                          edge_slots([r.n_edges for r in rows], e_pad))


def edge_layout(rows: List[SubgraphRows], n: int, slots: int):
    """The rows' edge arrays (src, dst, w, w_mean), [len(rows), slots]
    each: every row's ``n_edges`` real edges, then padding (a weight-0
    edge at the last, padded vertex n - 1)."""
    C = len(rows)
    es = np.full((C, slots), n - 1, np.int32)
    ed = np.full((C, slots), n - 1, np.int32)
    ew = np.zeros((C, slots), np.float32)
    ew_mean = np.zeros((C, slots), np.float32)
    if slots:
        for i, r in enumerate(rows):
            e = r.n_edges
            es[i, :e], ed[i, :e] = r.edge_src, r.edge_dst
            ew[i, :e], ew_mean[i, :e] = r.edge_w, r.edge_w_mean
    return es, ed, ew, ew_mean


def assemble_batch(g: CSRGraph, targets, node_lists: List[np.ndarray],
                   rows: List[SubgraphRows], n: int, slots: int,
                   build_feats: bool = True,
                   dense: bool = True) -> SubgraphBatch:
    """Pack per-target built rows into one fixed-shape SubgraphBatch
    (the Pack stage's structure half; features are materialized here only
    for strategies that ship the dense block). The edge arrays take
    ``slots`` slots (0: no edge layout, for a batch that ships none).
    ``dense=False`` leaves the [C, N, N] adjacency out ([C, 0, 0]), for a
    batch that ships none."""
    C = len(rows)
    f = g.feature_dim if build_feats else 0   # [C, n, 0]: shape carriers
    feats = np.zeros((C, n, f), np.float32)   # (n, batch_size) stay valid
    nn = n if dense else 0
    adj = np.zeros((C, nn, nn), np.float32)
    adj_mean = np.zeros((C, nn, nn), np.float32)
    mask = np.zeros((C, n), np.float32)
    es, ed, ew, ew_mean = edge_layout(rows, n, slots)
    self_w = np.zeros((C, n), np.float32)
    nv = np.zeros(C, np.int32)
    ne = np.zeros(C, np.int32)
    for i, r in enumerate(rows):
        if dense:
            adj[i], adj_mean[i] = r.adj, r.adj_mean
        mask[i], self_w[i] = r.mask, r.self_w
        nv[i], ne[i] = r.n_vertices, r.n_edges
        if build_feats:
            nodes = node_lists[i][:n]
            feats[i, :len(nodes)] = g.features[nodes]
    return SubgraphBatch(feats=feats, adj=adj, adj_mean=adj_mean, mask=mask,
                         edge_src=es, edge_dst=ed, edge_w=ew,
                         n_vertices=nv, n_edges=ne,
                         targets=np.asarray(targets, np.int64),
                         self_w=self_w, edge_w_mean=ew_mean)


def batch_from_node_lists(g: CSRGraph, targets, node_lists: List[np.ndarray],
                          n: int, e_pad: int,
                          build_feats: bool = True) -> SubgraphBatch:
    rows = [build_subgraph_rows(g, nodes[:n], n, e_pad)
            for nodes in node_lists]
    return assemble_batch(g, targets, node_lists, rows, n, e_pad,
                          build_feats=build_feats)
