"""GAT (Velickovic et al., arXiv:1710.10903) over one subgraph a row,
heads concatenated, ELU after each layer, with the paper's max readout.
Each vertex attends over its neighbours in the subgraph and itself.
Plain PyTorch."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.gcn import layers, max_readout


def forward(cfg: dict, params, x, a, mask):
    """x [S, N, f_in], a [S, N, N] 0/1 induced adjacency, mask [S, N]
    -> embeddings [S, f_hidden]."""
    s, n, _ = x.shape
    heads = cfg["n_heads"]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    # a padded row attends to itself alone, so it stays finite
    attend = ((a > 0) & (mask[:, None, :] > 0)) | eye    # [S, i, j]
    h = x
    for p in layers(params, cfg["n_layers"]):
        z = (h @ p["w"]).reshape(s, n, heads, -1)
        src = torch.einsum("snhf,hf->snh", z, p["a_src"])
        dst = torch.einsum("snhf,hf->snh", z, p["a_dst"])
        e = F.leaky_relu(dst.permute(0, 2, 1)[..., :, None]
                         + src.permute(0, 2, 1)[..., None, :],
                         cfg["negative_slope"])             # [S, H, i, j]
        e = e.masked_fill(~attend[:, None], float("-inf"))
        alpha = torch.softmax(e, dim=-1)
        out = torch.einsum("shij,sjhf->sihf", alpha, z).reshape(s, n, -1)
        h = F.elu(out + p["b"]) * mask[..., None]
    return max_readout(h, mask)


def param_shapes(cfg: dict, f_in: int, f_out: int) -> dict:
    """One layer's parameters: name -> (shape, fan-in; 0 for a bias)."""
    fh = f_out // cfg["n_heads"]
    return {"w": ((f_in, f_out), f_in),
            "a_src": ((cfg["n_heads"], fh), fh),
            "a_dst": ((cfg["n_heads"], fh), fh),
            "b": ((f_out,), 0)}


def layer_flops(cfg: dict, c: int, n: int, f_in: int, f_out: int) -> float:
    """Operations of one layer over c subgraphs of n vertices in its dense
    form: H W, the two score projections, each head's n x n logits
    (add, LeakyReLU, mask, max, subtract, exp, sum, scale: 8 a pair) and
    the weighted sum; a multiply-add counted as 2."""
    heads = cfg["n_heads"]
    return (2.0 * c * n * f_in * f_out + 4.0 * c * n * f_out
            + 8.0 * c * heads * n * n + 2.0 * c * n * n * f_out)
