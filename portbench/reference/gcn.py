"""GCN (Kipf and Welling, arXiv:1609.02907) over one subgraph a row,
with the paper's max readout: h' = relu(A_hat h W + b), A_hat the
symmetrically normalized adjacency with self loops. Plain PyTorch."""
from __future__ import annotations

import torch

from portbench.reference.subgraph import gcn_norm


def layers(params, n_layers: int):
    """The per-layer parameter dicts, layer 0 first."""
    inner = params.get("layers", {})
    return [params["layer0"]] + [{k: v[i] for k, v in inner.items()}
                                 for i in range(n_layers - 1)]


def max_readout(h, mask):
    return h.masked_fill(mask[..., None] <= 0, float("-inf")).amax(1)


def forward(cfg: dict, params, x, a, mask):
    """x [S, N, f_in], a [S, N, N] 0/1 induced adjacency, mask [S, N]
    (1 = a selected vertex) -> embeddings [S, f_hidden]."""
    a_hat = gcn_norm(a)
    h = x
    for p in layers(params, cfg["n_layers"]):
        h = torch.relu(torch.bmm(a_hat, h) @ p["w"] + p["b"])
        h = h * mask[..., None]
    return max_readout(h, mask)


def param_shapes(cfg: dict, f_in: int, f_out: int) -> dict:
    """One layer's parameters: name -> (shape, fan-in; 0 for a bias)."""
    return {"w": ((f_in, f_out), f_in), "b": ((f_out,), 0)}


def layer_flops(cfg: dict, c: int, n: int, f_in: int, f_out: int) -> float:
    """Operations of one layer over c subgraphs of n vertices in its dense
    form: H W and A_hat (H W), a multiply-add counted as 2."""
    return 2.0 * c * n * f_in * f_out + 2.0 * c * n * n * f_out
