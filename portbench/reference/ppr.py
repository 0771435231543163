"""Select's answer, worked out again: the top-N personalized-PageRank
neighbourhood of a target by forward local push.

A frozen copy of the port's ``core/ini.py`` (``ppr_local_push``,
``select_important``), kept because the order of the approximate push
defines which N vertices are selected. numpy only.
"""
from __future__ import annotations

import numpy as np


def _gather_ranges(arr, starts, ends, total):
    out = np.empty(total, arr.dtype)
    o = 0
    for s, e in zip(starts, ends):
        ln = e - s
        out[o:o + ln] = arr[s:e]
        o += ln
    return out


def ppr_local_push(indptr, indices, target: int, alpha: float, eps: float,
                   max_iters: int = 1000):
    """(touched vertices, PPR estimates) of the push from ``target``."""
    v = len(indptr) - 1
    deg = np.diff(indptr)
    p = np.zeros(v, np.float64)
    r = np.zeros(v, np.float64)
    r[target] = 1.0
    touched = np.zeros(v, bool)
    touched[target] = True
    tarr = np.array([target], dtype=np.int64)
    thresh = np.maximum(deg, 1) * eps
    frontier = tarr
    for _ in range(max_iters):
        active = frontier[r[frontier] >= thresh[frontier]]
        if len(active) == 0:
            break
        r_act = r[active]
        p[active] += alpha * r_act
        r[active] = 0.0
        counts = (indptr[active + 1] - indptr[active]).astype(np.int64)
        has_nbrs = counts > 0
        act = active[has_nbrs]
        if len(act) == 0:
            frontier = active[:0]
            continue
        counts = counts[has_nbrs]
        shares = ((1.0 - alpha) * r_act[has_nbrs]) / counts
        nbrs = _gather_ranges(indices, indptr[act], indptr[act + 1],
                              int(counts.sum()))
        np.add.at(r, nbrs, np.repeat(shares, counts))
        uniq = np.unique(nbrs)
        new = uniq[~touched[uniq]]
        if len(new):
            touched[new] = True
            tarr = np.concatenate([tarr, new])
        frontier = tarr[r[tarr] >= thresh[tarr]]
        if len(frontier) == 0:
            break
    return tarr, p[tarr] + alpha * r[tarr]


def select(indptr, indices, target: int, n: int, alpha: float,
           eps: float) -> np.ndarray:
    """The target and its n-1 highest-scored neighbours, target first."""
    verts, scores = ppr_local_push(indptr, indices, target, alpha, eps)
    keep = verts != target
    verts, scores = verts[keep], scores[keep]
    if len(verts) > n - 1:
        top = np.argpartition(scores, -(n - 1))[-(n - 1):]
        verts = verts[top[np.argsort(-scores[top])]]
    else:
        verts = verts[np.argsort(-scores)]
    return np.concatenate([[target], verts]).astype(np.int64)
