"""Important Neighbor Identification (INI) — Personalized PageRank local
push (Andersen-Chung-Lang forward push), the paper's host-side subroutine
(Algorithm 2 line 2, §3.2).

The push loop is frontier-vectorized numpy: each iteration pushes the whole
above-threshold frontier at once with ``np.add.at`` instead of a per-vertex
deque, which is the multi-core-friendly formulation of [Aggarwal et al.,
HiPC'21] that the paper parallelizes over CPU threads. ``ini_batch`` runs
targets on a thread pool (the paper uses 8 host threads).

Also provides the dense power-iteration PPR oracle used by tests.
"""
from __future__ import annotations

from concurrent.futures import Executor, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graphs.csr import CSRGraph, _gather_ranges


def ppr_local_push(g: CSRGraph, target: int, alpha: float = 0.15,
                   eps: float = 1e-4, max_iters: int = 1000
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate PPR vector for ``target`` via forward local push.

    Invariant maintained:  p + alpha * r  ==  ppr  (up to push residue);
    push rule: while r[u] >= eps * deg(u):
        p[u] += alpha * r[u];  r[neighbors] += (1-alpha) * r[u] / deg(u)

    Returns (touched_vertices [k], scores [k]) with scores = p estimates,
    target always included.
    """
    deg = g.degrees
    # sparse p/r held as dense float arrays over touched region only would
    # need hashing; at these graph scales dense [V] float32 is cheap and the
    # frontier ops stay O(touched).
    p = np.zeros(g.num_vertices, np.float64)
    r = np.zeros(g.num_vertices, np.float64)
    r[target] = 1.0
    # touched bookkeeping is a boolean mask + a growing id array: the mask
    # answers "seen before?" in O(1) numpy and tarr enumerates the touched
    # set without per-iteration Python-object traffic (set / np.fromiter)
    touched = np.zeros(g.num_vertices, bool)
    touched[target] = True
    tarr = np.array([target], dtype=np.int64)
    thresh = np.maximum(deg, 1) * eps
    frontier = tarr
    for _ in range(max_iters):
        mask = r[frontier] >= thresh[frontier]
        active = frontier[mask]
        if len(active) == 0:
            break
        r_act = r[active]
        p[active] += alpha * r_act
        r[active] = 0.0
        # distribute (1-alpha)*r_u evenly over out-neighbors
        counts = (g.indptr[active + 1] - g.indptr[active]).astype(np.int64)
        has_nbrs = counts > 0
        act = active[has_nbrs]
        if len(act) == 0:
            frontier = active[:0]
            continue
        counts = counts[has_nbrs]
        shares = ((1.0 - alpha) * r_act[has_nbrs]) / counts
        nbrs = _gather_ranges(g.indices, g.indptr[act], g.indptr[act + 1],
                              int(counts.sum()))
        np.add.at(r, nbrs, np.repeat(shares, counts))
        uniq = np.unique(nbrs)
        new = uniq[~touched[uniq]]
        if len(new):
            touched[new] = True
            tarr = np.concatenate([tarr, new])
        # next frontier = all touched vertices above threshold
        frontier = tarr[r[tarr] >= thresh[tarr]]
        if len(frontier) == 0:
            break
    scores = p[tarr] + alpha * r[tarr]   # fold residual for a tighter est.
    return tarr, scores


def select_important(g: CSRGraph, target: int, n: int, alpha: float = 0.15,
                     eps: float = 1e-4,
                     with_frontier: bool = False) -> np.ndarray:
    """Top-(n-1) PPR neighbors plus the target itself (target first).

    ``with_frontier=True`` additionally returns the push's full touched
    set (every vertex the local push reached, sorted) — the exact
    invalidation footprint: a graph update at ANY touched vertex can
    shift the target's PPR scores and therefore its top-N selection,
    even when that vertex fell below the top-N cutoff."""
    verts, scores = ppr_local_push(g, target, alpha, eps)
    frontier = np.sort(verts) if with_frontier else None
    keep = verts != target
    verts, scores = verts[keep], scores[keep]
    if len(verts) > n - 1:
        top = np.argpartition(scores, -(n - 1))[-(n - 1):]
        verts = verts[top[np.argsort(-scores[top])]]
    else:
        verts = verts[np.argsort(-scores)]
    sel = np.concatenate([[target], verts]).astype(np.int64)
    return (sel, frontier) if with_frontier else sel


def ini_batch(g: CSRGraph, targets, n: int, alpha: float = 0.15,
              eps: float = 1e-4, num_threads: int = 8,
              with_frontier: bool = False,
              executor: Optional[Executor] = None) -> List[np.ndarray]:
    """INI for a batch of targets on a host thread pool (paper: 8 threads).

    ``with_frontier=True`` returns ``(node_list, touched_set)`` pairs —
    see ``select_important``. Pass a persistent ``executor`` to amortize
    pool construction across batches (the Select stage owns one for its
    engine's lifetime); without one, a pool is built per call."""
    def one(t):
        return select_important(g, int(t), n, alpha, eps, with_frontier)
    if executor is not None and len(targets) > 1:
        return list(executor.map(one, targets))
    if num_threads <= 1 or len(targets) <= 1:
        return [one(t) for t in targets]
    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(one, targets))


def ppr_power_iteration(g: CSRGraph, target: int, alpha: float = 0.15,
                        iters: int = 200) -> np.ndarray:
    """Dense PPR oracle (tests only, graphs <= a few thousand vertices).

    ppr = alpha * e_t + (1-alpha) * ppr @ D^-1 A  (row-stochastic walk)."""
    V = g.num_vertices
    deg = np.maximum(g.degrees, 1).astype(np.float64)
    pi = np.zeros(V)
    pi[target] = 1.0
    e = pi.copy()
    for _ in range(iters):
        nxt = np.zeros(V)
        # one step of the walk: mass/deg to each out-neighbor
        contrib = pi / deg
        np.add.at(nxt, g.indices, np.repeat(contrib, np.diff(g.indptr)))
        pi = alpha * e + (1.0 - alpha) * nxt
    return pi
