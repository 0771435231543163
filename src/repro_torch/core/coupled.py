"""Coupled (recursive message-passing) GNN baseline — Algorithm 1 (a copy
of ``repro.core.coupled``, numpy only; parameter trees may hold this
package's tensors, read through ``.cpu().numpy()``).

Two roles:
  1. *Performance baseline* (Figs. 1/3/8): ``lhop_nodes`` materializes the
     exploding L-hop receptive field (optionally fanout-sampled like
     GraphSAGE / GraphACT) so benchmarks can measure the exponential
     compute/communication growth the paper argues against.
  2. *Correctness oracle*: ``coupled_reference_embedding`` is a literal,
     independent numpy implementation of Algorithm 1's recursion. For any
     target, decoupled inference over the FULL L-hop induced subgraph with
     readout='target' must equal it exactly — the paper's equivalence.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.graphs.csr import CSRGraph, subgraph_edges


def lhop_nodes(g: CSRGraph, target: int, L: int,
               fanouts: Optional[Sequence[int]] = None,
               seed: int = 0) -> np.ndarray:
    """Vertices within L hops (target first). ``fanouts[l]`` caps sampled
    neighbors per vertex at hop l (GraphSAGE-style); None = full expansion."""
    rng = np.random.default_rng(seed + target)
    seen = {int(target)}
    frontier = np.array([target], dtype=np.int64)
    order = [int(target)]
    for hop in range(L):
        nxt = []
        for u in frontier:
            nbrs = g.neighbors(int(u))
            if fanouts is not None and len(nbrs) > fanouts[hop]:
                nbrs = rng.choice(nbrs, size=fanouts[hop], replace=False)
            nxt.append(nbrs)
        if not nxt:
            break
        cand = np.unique(np.concatenate(nxt))
        new = [int(v) for v in cand if int(v) not in seen]
        seen.update(new)
        order.extend(new)
        frontier = np.array(new, dtype=np.int64)
        if len(frontier) == 0:
            break
    return np.array(order, dtype=np.int64)


def receptive_field_size(g: CSRGraph, targets, L: int,
                         fanouts=None) -> float:
    """Average |L-hop receptive field| — the O(d^L) growth curve (Fig. 1)."""
    return float(np.mean([len(lhop_nodes(g, int(t), L, fanouts))
                          for t in targets]))


# ---------------------------------------------------------------------------
# Algorithm 1 oracle (independent implementation: per-vertex numpy loops)


def _np(x) -> np.ndarray:
    """A parameter leaf as numpy: tensors (on any device) through
    ``.detach().cpu().numpy()``, the rest through ``np.asarray``."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gcn_norm_weights(nodes: np.ndarray, src: np.ndarray, dst: np.ndarray):
    """Same normalization convention as core.subgraph.build_subgraph:
    deg = in-degree within the induced subgraph + 1 (self loop)."""
    k = len(nodes)
    deg = np.ones(k, np.float64)
    np.add.at(deg, dst, 1.0)
    return 1.0 / np.sqrt(deg)


def coupled_reference_embedding(g: CSRGraph, target: int, L: int,
                                params: Dict, kind: str = "gcn"
                                ) -> np.ndarray:
    """h_target^L via the message-passing recursion of Algorithm 1 over the
    L-hop neighborhood, with layer math matching repro_torch.gnn.layers (fp64
    numpy — an independent code path from the jitted engine).

    Supports kind in {gcn, sage}. GAT/GIN equivalence is exercised through
    the engine-level dense==sg property instead.
    """
    nodes = lhop_nodes(g, target, L)
    k = len(nodes)
    src, dst = subgraph_edges(g, nodes)
    inv_sqrt = _gcn_norm_weights(nodes, src, dst)
    indeg = np.zeros(k, np.float64)
    np.add.at(indeg, dst, 1.0)

    nbrs_in: list = [[] for _ in range(k)]   # incoming edges per dst
    for s, d in zip(src, dst):
        nbrs_in[d].append(s)

    h = g.features[nodes].astype(np.float64)
    for layer in range(L):
        p = {key: _np(v) for key, v in params["layer0"].items()} \
            if layer == 0 else {
            key: _np(v)[layer - 1] for key, v in
            params["layers"].items()}
        new_h = np.zeros((k, np.asarray(
            p["w" if kind == "gcn" else "w_self"]).shape[1]))
        for j in range(k):
            if kind == "gcn":
                z = inv_sqrt[j] * inv_sqrt[j] * h[j]          # self loop
                for s in nbrs_in[j]:
                    z = z + inv_sqrt[j] * inv_sqrt[s] * h[s]
                out = z @ np.asarray(p["w"]) + np.asarray(p["b"])
            else:                                             # sage-mean
                if nbrs_in[j]:
                    z = np.mean([h[s] for s in nbrs_in[j]], axis=0)
                else:
                    z = np.zeros_like(h[j])
                out = (h[j] @ np.asarray(p["w_self"])
                       + z @ np.asarray(p["w_neigh"])
                       + np.asarray(p["b"]))
            new_h[j] = np.maximum(out, 0.0)                   # relu
        h = new_h
    return h[0]   # target is nodes[0]


def coupled_cost_model(g: CSRGraph, targets, L: int, f: int,
                       fanouts=None) -> Dict[str, float]:
    """Computation / communication cost of the Coupled model (paper §3.2):
    compute O(N_rf * f^2), host->device bytes O(N_rf * f)."""
    n_rf = receptive_field_size(g, targets, L, fanouts)
    return {
        "receptive_field": n_rf,
        "flops_per_target": 2.0 * n_rf * f * f * L / max(L, 1) * L,
        "bytes_per_target": 4.0 * n_rf * f,
    }
