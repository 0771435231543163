"""Synthetic graph generators statistically matched to the paper's datasets.

The container is offline, so Flickr / Reddit / ogbn-arxiv (Table 4) are
replaced by power-law graphs matching their vertex count, average degree,
feature dim and class count. A ``scale`` knob shrinks vertex count for unit
tests while preserving degree structure. Generation is vectorized numpy
(configuration-model with preferential weights, symmetrized, deduped).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graphs.csr import CSRGraph, from_edge_list


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_vertices: int
    avg_degree: float        # directed out-degree before symmetrization
    feature_dim: int
    num_classes: int
    power: float = 2.2       # degree power-law exponent


# Paper Table 4 statistics. Reddit's 116M edges (~500 eff. degree) exceed
# this container's memory at full scale; its spec keeps the paper's stated
# degree-50 figure and benchmarks use scale<=0.5.
FLICKR = DatasetSpec("flickr", 89_250, 10.0, 500, 7)
REDDIT = DatasetSpec("reddit", 232_965, 50.0, 602, 41)
OGBN_ARXIV = DatasetSpec("ogbn-arxiv", 169_343, 7.0, 128, 40)

DATASETS = {d.name: d for d in (FLICKR, REDDIT, OGBN_ARXIV)}


def powerlaw_degrees(n: int, avg: float, power: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Degree sequence ~ Pareto(power-1) scaled to the requested mean."""
    raw = (1.0 / rng.power(power - 1.0, size=n))  # pareto >= 1
    raw = np.clip(raw, 1.0, n / 4)
    deg = raw * (avg / raw.mean())
    return np.maximum(1, deg.round().astype(np.int64))


def make_graph(spec: DatasetSpec, scale: float = 1.0,
               seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    n = max(64, int(spec.num_vertices * scale))
    deg = powerlaw_degrees(n, spec.avg_degree, spec.power, rng)
    m = int(deg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    # preferential endpoint choice: weight by degree (power-law assortative)
    w = deg.astype(np.float64)
    p = w / w.sum()
    dst = rng.choice(n, size=m, p=p).astype(np.int64)
    # homophilous labels (like real GNN benchmarks): seed random labels,
    # then a few majority-propagation rounds over the edges so neighbors
    # correlate — aggregation then genuinely helps classification
    labels = rng.integers(0, spec.num_classes, size=n).astype(np.int32)
    for _ in range(3):
        onehot = np.zeros((n, spec.num_classes), np.float32)
        onehot[np.arange(n), labels] = 1.0
        votes = np.zeros_like(onehot)
        np.add.at(votes, dst, onehot[src])
        np.add.at(votes, src, onehot[dst])
        votes += 0.5 * onehot                    # self-weight breaks ties
        labels = votes.argmax(1).astype(np.int32)
    centers = rng.standard_normal((spec.num_classes, spec.feature_dim))
    feats = (centers[labels] +
             0.5 * rng.standard_normal((n, spec.feature_dim))
             ).astype(np.float32)
    return from_edge_list(src, dst, n, feats, symmetrize=True,
                          labels=labels, name=spec.name)


_CACHE: dict = {}


def get_graph(name: str, scale: float = 1.0, seed: int = 0) -> CSRGraph:
    key = (name, scale, seed)
    if key not in _CACHE:
        _CACHE[key] = make_graph(DATASETS[name], scale, seed)
    return _CACHE[key]


def zipf_traffic(g: CSRGraph, n_requests: int, a: float = 1.1,
                 seed: int = 0) -> np.ndarray:
    """Zipf(a) popularity-skewed request targets over a finite support,
    with popularity rank following vertex degree (hubs are hot — the
    realistic and cacheable serving regime the store subsystem targets).
    Exact finite-support sampling via inverse-CDF weights. THE one traffic
    model shared by bench_store, examples, and cache tests."""
    rng = np.random.default_rng(seed)
    v = g.num_vertices
    probs = 1.0 / np.arange(1, v + 1, dtype=np.float64) ** a
    probs /= probs.sum()
    ranks = rng.choice(v, size=n_requests, p=probs)
    by_degree = np.argsort(-g.degrees.astype(np.int64), kind="stable")
    return by_degree[ranks]
