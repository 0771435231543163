"""The plain reference: what a served embedding should be, worked out
again from the benchmark's own graph, features and weights.

For each target: Select (``ppr.select``, a frozen copy of the port's
push), Build (``subgraph.induced_adjacency``), the feature gather (rows of
the benchmark's feature matrix), then the configuration's model, named by
its ``reference`` key (``gcn.py``, ``gat.py``), with its max readout. fp32
on the given device, with TF32 off unless ``tf32`` asks for it (the
control). Nothing here imports the program or JAX.
"""
from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from portbench.reference.ppr import select
from portbench.reference.subgraph import induced_adjacency


@dataclass
class Subgraph:
    """One target's selected vertices and induced 0/1 adjacency."""
    target: int
    nodes: np.ndarray
    adj: np.ndarray


def build(graph, cfg: dict, targets: Sequence[int]) -> List[Subgraph]:
    """Select and Build for each target, on the host."""
    n = cfg["receptive_field"]
    out = []
    for t in targets:
        nodes = select(graph.indptr, graph.indices, int(t), n,
                       cfg["ppr_alpha"], cfg["ppr_eps"])
        out.append(Subgraph(int(t), nodes,
                            induced_adjacency(graph.indptr, graph.indices,
                                              nodes)))
    return out


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """fp32 products in full fp32 (tf32=False) or in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def embed(graph, cfg: dict, params, subgraphs: List[Subgraph], device,
          tf32: bool = False, block: int = 128) -> np.ndarray:
    """The model's embeddings [len(subgraphs), f_hidden] (float32), run in
    blocks of ``block`` subgraphs so that it fits beside anything else."""
    model = importlib.import_module(
        f"portbench.reference.{cfg['reference']}")
    n = cfg["receptive_field"]
    f_in = graph.features.shape[1]
    out = []
    for i in range(0, len(subgraphs), block):
        chunk = subgraphs[i:i + block]
        x = np.zeros((len(chunk), n, f_in), np.float32)
        a = np.zeros((len(chunk), n, n), np.float32)
        mask = np.zeros((len(chunk), n), np.float32)
        for s, sg in enumerate(chunk):
            k = len(sg.nodes)
            x[s, :k] = graph.features[sg.nodes]
            a[s, :k, :k] = sg.adj
            mask[s, :k] = 1.0
        with torch.no_grad(), matmul_precision(tf32):
            emb = model.forward(cfg, params,
                                torch.from_numpy(x).to(device),
                                torch.from_numpy(a).to(device),
                                torch.from_numpy(mask).to(device))
        out.append(emb.float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)
