"""Precompute artifact persistence: the embedding table through the
package's checkpoints (``ckpt.checkpoint``, the reference's on-disk layout).

The PyTorch counterpart of ``repro.precompute.artifact``. The artifact is
one committed checkpoint step holding the [V, f_out] embedding matrix,
stamped with fingerprints of everything the rows are a pure function of:
the graph's CSR arrays + features, the model signature, and the parameter
values. The fingerprints hash numpy views of the tensors exactly as the
reference hashes its arrays (dtype, shape, bytes; parameter leaves in
sorted key order), so an artifact of either package loads in the other
when the deployment is the same. Loading validates every stamp against the
live deployment: a mutated graph or different weights fail loudly with a
rebuild instruction, never serve stale embeddings.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.precompute.propagate import PrecomputeError


class PrecomputeArtifactError(PrecomputeError):
    """Artifact does not match the live graph/model deployment."""


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def graph_fingerprint(graph) -> str:
    return _sha(graph.indptr, graph.indices, graph.features)


def params_fingerprint(params) -> str:
    leaves = ckpt._flatten(params)          # sorted key paths, as jax's
    return _sha(*[_host(leaves[k]) for k in leaves])


def model_signature(cfg) -> dict:
    return {"kind": cfg.kind, "n_layers": cfg.n_layers,
            "f_in": cfg.f_in, "f_hidden": cfg.f_hidden,
            "num_classes": cfg.num_classes, "readout": cfg.readout,
            "ppr_alpha": cfg.ppr_alpha}


def save_artifact(out_dir: str, embeddings: np.ndarray, graph, cfg,
                  params, generation: int = 0) -> str:
    """Write the embedding matrix + stamps as one committed checkpoint
    step; returns the artifact directory."""
    extra = {"schema": 1,
             "graph_fingerprint": graph_fingerprint(graph),
             "params_fingerprint": params_fingerprint(params),
             "model": model_signature(cfg),
             "generation": int(generation),
             "num_vertices": int(embeddings.shape[0]),
             "f_out": int(embeddings.shape[1])}
    ckpt.save(out_dir, 0, {"embeddings": np.asarray(embeddings,
                                                    np.float32)},
              extra=extra)
    return out_dir


def load_artifact(path: str, graph, cfg, params) -> np.ndarray:
    """Load + validate an artifact against the live deployment. Raises
    ``PrecomputeArtifactError`` naming the first mismatched stamp."""
    tree, _, extra = ckpt.restore(
        path, {"embeddings": np.zeros((0, 0), np.float32)})
    remedy = (f"rebuild it with `python -m repro_torch.precompute.build "
              f"--out {path}` (plus the deployment's --dataset/--kind "
              f"flags) or drop PrecomputeConfig(artifact=...) to build "
              f"at engine construction")
    checks = [
        ("graph_fingerprint", graph_fingerprint(graph),
         "the graph (CSR structure or features) has changed since the "
         "artifact was built — its rows would silently serve wrong "
         "embeddings"),
        ("model", model_signature(cfg),
         "the model configuration differs from the one the artifact was "
         "built for"),
        ("params_fingerprint", params_fingerprint(params),
         "the model parameters differ from the ones the artifact was "
         "built with (seed / checkpoint mismatch)"),
    ]
    for key, live, why in checks:
        if extra.get(key) != live:
            raise PrecomputeArtifactError(
                f"stale precompute artifact at {path!r}: {key} mismatch "
                f"(artifact {extra.get(key)!r} vs live {live!r}). "
                f"{why}; {remedy}.")
    emb = np.asarray(tree["embeddings"], np.float32)
    if emb.shape[0] != graph.num_vertices:
        raise PrecomputeArtifactError(
            f"stale precompute artifact at {path!r}: {emb.shape[0]} rows "
            f"vs {graph.num_vertices} live vertices; {remedy}.")
    return emb


__all__ = ["PrecomputeArtifactError", "save_artifact", "load_artifact",
           "graph_fingerprint", "params_fingerprint", "model_signature"]
