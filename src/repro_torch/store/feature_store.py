"""Feature shipping strategies: how a batch's feature rows reach the device.

Two strategies share one interface (``host_payload`` on the host side of
the pipeline, ``device_feats`` on the device side), so the engine's
prepare/run_device stay strategy-agnostic:

  * ``DenseFeatureShipper``  — the baseline: every batch carries its own
    [C, N, f_pad] feature rows (the paper's t_load paid in full).
  * ``PackedFeatureShipper`` — cross-target dedup: unique rows once per
    batch plus an int32 index map, gathered on the device.

Host arrays cross to the device through a pinned host tensor and a
non-blocking copy on the current stream (``to_device``); the
device-resident strategies of the reference (``"resident"``,
``"sharded"``) are not ported yet and raise in ``build_feature_source``.
All strategies emit feature rows padded to the engine's feature width
(``f_pad``), so padding is decided exactly once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.csr import CSRGraph


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: for a CUDA device through a
    pinned staging tensor and a non-blocking copy on the current stream
    (the caching host allocator keeps the staging buffer alive until the
    copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_feature_dim(feats, f_pad: int):
    """THE one feature-padding implementation: zero-pad the trailing dim
    to f_pad (exact, because the matching layer0 weight rows are zero).
    numpy arrays or torch tensors, any leading shape; no-op when already
    at f_pad."""
    pad = f_pad - feats.shape[-1]
    if pad == 0:
        return feats
    if pad < 0:
        raise ValueError(f"feature dim {feats.shape[-1]} exceeds "
                         f"f_pad={f_pad}")
    if isinstance(feats, torch.Tensor):
        return torch.nn.functional.pad(feats, (0, pad))
    widths = [(0, 0)] * (feats.ndim - 1) + [(0, pad)]
    return np.pad(feats, widths)


class DenseFeatureShipper:
    """Baseline: ship the dense [C, N, f_pad] block every batch."""

    name = "dense"
    needs_host_feats = True
    payload_keys = ("feats",)

    def __init__(self, graph: CSRGraph, f_pad: int, device):
        self.graph, self.f_pad = graph, f_pad
        self.device = torch.device(device)

    def host_payload(self, node_lists: List[np.ndarray], n: int,
                     feats: Optional[np.ndarray]
                     ) -> Tuple[Dict[str, np.ndarray], Optional[float]]:
        return {"feats": pad_feature_dim(feats, self.f_pad)}, None

    def device_feats(self, payload: Dict) -> torch.Tensor:
        return to_device(payload["feats"], self.device)

    def report(self) -> dict:
        return {"strategy": self.name}


class PackedFeatureShipper:
    """Cross-target dedup: unique rows [U, f] + int32 index map [C, N].

    PPR favors hubs, so the same vertices recur across a batch's subgraphs;
    each unique row crosses the link once and ``index_select`` rebuilds the
    [C, N, f] block on the device. ``ratio`` (packed/dense bytes) is
    surfaced per batch as the dedup ratio."""

    name = "packed"
    needs_host_feats = False
    payload_keys = ("uniq_feats", "feat_idx")

    def __init__(self, graph: CSRGraph, f_pad: int, device):
        self.graph, self.f_pad = graph, f_pad
        self.device = torch.device(device)

    def host_payload(self, node_lists, n, feats=None):
        from repro_torch.core.subgraph import packed_features
        uniq, idx, _ = packed_features(node_lists, self.graph, n)
        # ship at f_in — the device pads AFTER the gather (run_device's
        # pad_feature_dim), so the link never carries pad zeros. The
        # ratio denominator uses f_pad because that is what the dense
        # strategy ships
        ratio = (uniq.nbytes + idx.nbytes) / \
            (idx.shape[0] * idx.shape[1] * self.f_pad * 4)
        return {"uniq_feats": uniq, "feat_idx": idx}, ratio

    def device_feats(self, payload):
        uniq = to_device(payload["uniq_feats"], self.device)
        idx = to_device(payload["feat_idx"], self.device).long()
        return uniq.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, uniq.shape[-1])

    def report(self) -> dict:
        return {"strategy": self.name}


def build_feature_source(graph: CSRGraph, policy, f_pad: int, device):
    """Strategy factory keyed on ``StorePolicy.features``."""
    if policy.features == "dense":
        return DenseFeatureShipper(graph, f_pad, device)
    if policy.features == "packed":
        return PackedFeatureShipper(graph, f_pad, device)
    if policy.features in ("resident", "sharded"):
        raise NotImplementedError(
            f"StorePolicy.features={policy.features!r}: the device-resident "
            f"feature stores are not ported to repro_torch yet (use "
            f"'dense' or 'packed')")
    raise ValueError(f"unknown feature strategy {policy.features!r}")
