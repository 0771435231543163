"""Build's answer, worked out again: the induced subgraph of a selected
vertex set as a dense 0/1 adjacency, and the normalized forms the models
read. Written from the definitions, not copied from the program."""
from __future__ import annotations

import numpy as np
import torch


def induced_adjacency(indptr, indices, nodes: np.ndarray) -> np.ndarray:
    """A[i, j] = 1 where nodes[j] is a neighbour of nodes[i] ([k, k],
    float32; the graph is symmetric and has no self loops)."""
    k = len(nodes)
    order = np.argsort(nodes)
    ordered = nodes[order]
    a = np.zeros((k, k), np.float32)
    for i, v in enumerate(nodes):
        nbrs = indices[indptr[v]:indptr[v + 1]]
        at = np.minimum(np.searchsorted(ordered, nbrs), k - 1)
        inside = ordered[at] == nbrs
        a[i, order[at[inside]]] = 1.0
    return a


def gcn_norm(a: torch.Tensor) -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2 with D the degrees of A + I ([..., k, k])."""
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    a_hat = a.double() + eye
    d = a_hat.sum(-1).rsqrt()
    return (d[..., :, None] * a_hat * d[..., None, :]).float()
