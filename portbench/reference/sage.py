"""GraphSAGE (Hamilton et al., arXiv:1706.02216) with the mean aggregator,
over one subgraph a row, with the paper's max readout:

    h'_v = relu(W_self h_v + W_neigh mean_{u in N(v)} h_u + b)

N(v) is v's in-neighbours in the induced subgraph, without v itself; a
vertex with none aggregates 0. Plain PyTorch, fp32.

Departures from Hamilton et al., as arXiv:2206.08536 serves the model:
- the neighbourhood is the whole induced subgraph of the target's
  PPR-selected vertices, not a fixed-size sample of each hop;
- no L2 normalization of the embeddings after a layer (Algorithm 1, line
  7); relu and the bias on every layer, the last included;
- CONCAT(h_v, mean) W is written as two weights, W_self and W_neigh (the
  same function);
- the embedding is the max over the subgraph's vertices (the decoupled
  readout), not the target's own row.
"""
from __future__ import annotations

import torch

from portbench.reference.gcn import layers, max_readout


def mean_adjacency(a):
    """Row v of ``a`` [S, N, N] (0/1, a[v, u] = 1 where u is a neighbour
    of v) over v's neighbour count; a row with none stays 0."""
    return a / a.sum(-1, keepdim=True).clamp(min=1.0)


def forward(cfg: dict, params, x, a, mask):
    """x [S, N, f_in], a [S, N, N] 0/1 induced adjacency, mask [S, N]
    (1 = a selected vertex) -> embeddings [S, f_hidden]."""
    a_mean = mean_adjacency(a)
    h = x
    for p in layers(params, cfg["n_layers"]):
        h = torch.relu(h @ p["w_self"] + torch.bmm(a_mean, h) @ p["w_neigh"]
                       + p["b"])
        h = h * mask[..., None]
    return max_readout(h, mask)


def param_shapes(cfg: dict, f_in: int, f_out: int) -> dict:
    """One layer's parameters: name -> (shape, fan-in; 0 for a bias)."""
    return {"w_self": ((f_in, f_out), f_in),
            "w_neigh": ((f_in, f_out), f_in),
            "b": ((f_out,), 0)}


def layer_flops(cfg: dict, c: int, n: int, f_in: int, f_out: int) -> float:
    """Operations of one layer over c subgraphs of n vertices in its dense
    form: the mean A H at f_in and the two weights' products, a
    multiply-add counted as 2."""
    return 2.0 * c * n * n * f_in + 2.0 * 2.0 * c * n * f_in * f_out
