"""The benchmark's graph and its vertices' popularity ranks, made from a
seed.

A frozen copy of the port's synthetic generator (``graphs/synthetic.py``:
``powerlaw_degrees``, ``make_graph``, and ``zipf_traffic``'s ranking of
vertices by degree) and of ``graphs/csr.py``'s ``from_edge_list``, so
that later changes to the program cannot change the benchmark's input.
The label-propagation rounds count votes with ``np.bincount`` where the
original uses ``np.add.at``: the votes are sums of ones and halves, exact
in float32 either way, so the graph is bitwise the original's. numpy
only: nothing here imports the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class GraphSpec:
    """A Flickr-sized power-law graph (the paper's Table 4 statistics)."""
    num_vertices: int
    avg_degree: float         # directed out-degree before symmetrization
    feature_dim: int
    num_classes: int
    power: float = 2.2
    # where set, the graph (edges and features) is made from this seed and
    # the run's seed only relabels its vertices: every run gets the same
    # degrees, fields and subgraph sizes, in another order
    structure_seed: Optional[int] = None


@dataclass
class Graph:
    """CSR arrays over out-edges, symmetrized and deduplicated, without
    self loops; features [V, f] float32."""
    indptr: np.ndarray        # [V+1] int64
    indices: np.ndarray       # [E] int32
    features: np.ndarray      # [V, f] float32

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def powerlaw_degrees(n: int, avg: float, power: float,
                     rng: np.random.Generator) -> np.ndarray:
    raw = 1.0 / rng.power(power - 1.0, size=n)
    raw = np.clip(raw, 1.0, n / 4)
    deg = raw * (avg / raw.mean())
    return np.maximum(1, deg.round().astype(np.int64))


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n: int,
                   features: np.ndarray) -> Graph:
    """Symmetrize, drop self loops, dedup, and lay out as CSR."""
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if len(src):
        uniq = np.concatenate([[True], (np.diff(src) != 0)
                               | (np.diff(dst) != 0)])
        src, dst = src[uniq], dst[uniq]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return Graph(indptr=indptr, indices=dst.astype(np.int32),
                 features=features)


def relabel(g: Graph, seed: int) -> Graph:
    """``g`` with its vertices renumbered by a permutation drawn from the
    seed: vertex ``i`` becomes ``perm[i]``, with its edges and features."""
    n = g.num_vertices
    perm = np.random.default_rng([seed, 11]).permutation(n)
    src = perm[np.repeat(np.arange(n, dtype=np.int64), g.degrees)]
    dst = perm[g.indices.astype(np.int64)]
    order = np.lexsort((dst, src))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    feats = np.empty_like(g.features)
    feats[perm] = g.features
    return Graph(indptr=indptr, indices=dst[order].astype(np.int32),
                 features=feats)


def make_run_graph(spec: GraphSpec, seed: int) -> Graph:
    """The run's graph: made from the run's seed, or, where the spec fixes
    ``structure_seed``, made from that and relabelled by the run's seed."""
    if spec.structure_seed is None:
        return make_graph(spec, seed)
    return relabel(make_graph(spec, spec.structure_seed), seed)


def make_graph(spec: GraphSpec, seed: int) -> Graph:
    rng = np.random.default_rng(seed)
    n = spec.num_vertices
    k = spec.num_classes
    deg = powerlaw_degrees(n, spec.avg_degree, spec.power, rng)
    m = int(deg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    w = deg.astype(np.float64)
    dst = rng.choice(n, size=m, p=w / w.sum()).astype(np.int64)
    labels = rng.integers(0, k, size=n).astype(np.int32)
    for _ in range(3):
        votes = (np.bincount(dst * k + labels[src], minlength=n * k)
                 + np.bincount(src * k + labels[dst], minlength=n * k)
                 ).reshape(n, k).astype(np.float32)
        votes[np.arange(n), labels] += 0.5
        labels = votes.argmax(1).astype(np.int32)
    centers = rng.standard_normal((k, spec.feature_dim))
    feats = (centers[labels]
             + 0.5 * rng.standard_normal((n, spec.feature_dim))
             ).astype(np.float32)
    return csr_from_edges(src, dst, n, feats)


def ranked(g: Graph, support: int = None) -> np.ndarray:
    """Vertices by popularity rank, hottest first, as ``zipf_traffic``
    ranks them (degree, a stable sort, so ties keep vertex order); the
    first ``support`` of them, or all where ``support`` is None."""
    order = np.argsort(-g.degrees.astype(np.int64), kind="stable")
    return order if support is None else order[:support]
