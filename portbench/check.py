"""Whether the timed path's answers are right: every served request of a
sample of the window's targets, drawn from the seed with the hottest
target in it, against the plain reference (``portbench/reference``),
which selects, builds, gathers and runs the model again from the
benchmark's own graph and weights.

The number compared, ``emb_gap``: the worst over those requests of
max |served - reference| over the embedding, over the larger of the
reference row's max |.| and the sample's median of it. ``never_came``:
requests of the window that got no answer, or an error.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from portbench import reference


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)

    def line(self) -> str:
        return f"check {self.name} {self.value!r} limit {self.limit!r}"


def sample_targets(served: np.ndarray, size: int, seed: int) -> np.ndarray:
    """The most served target and ``size``-1 others drawn from the seed."""
    uniq, counts = np.unique(served, return_counts=True)
    hottest = uniq[np.argmax(counts)]
    rest = uniq[uniq != hottest]
    rng = np.random.default_rng([seed, 13])
    pick = rng.choice(rest, size=min(size - 1, len(rest)), replace=False)
    return np.concatenate([[hottest], pick]).astype(np.int64)


def row_gaps(got: np.ndarray, want: np.ndarray,
             scale: Optional[float] = None) -> np.ndarray:
    """max |got - want| a row over max(|want| a row, ``scale``); ``scale``
    defaults to the median over the rows of max |want|. Not finite -> inf."""
    norm = np.abs(want).max(axis=1)
    if scale is None:
        scale = float(np.median(norm))
    gap = np.abs(got.astype(np.float64) - want).max(axis=1) \
        / np.maximum(norm, scale)
    return np.where(np.isfinite(gap), gap, np.inf)


def reference_rows(graph, cfg: dict, params, targets: np.ndarray,
                   device) -> Dict[int, np.ndarray]:
    subgraphs = reference.build(graph, cfg, targets)
    emb = reference.embed(graph, cfg, params, subgraphs, device)
    return {sg.target: emb[i] for i, sg in enumerate(subgraphs)}


def judge(sent: List, graph, cfg: dict, params, device, seed: int,
          limits: Optional[dict] = None):
    """(checks, requests compared) of one run over its window's
    requests."""
    limits = limits or cfg["check"]["limits"]
    bad = [s.t_seen == 0.0 or s.req.error is not None
           or s.req.embedding is None for s in sent]
    answered = [s for s, b in zip(sent, bad) if not b]
    checks = [Check("never_came", float(sum(bad)),
                    float(limits["never_came"]))]
    if not answered:
        return checks + [Check("emb_gap", float("inf"),
                               float(limits["emb_gap"]))], 0
    served = np.array([s.target for s in answered])
    sample = sample_targets(served, cfg["check"]["sample_targets"], seed)
    ref = reference_rows(graph, cfg, params, sample, device)
    scale = float(np.median([np.abs(r).max() for r in ref.values()]))
    mine = [s for s in answered if s.target in ref]
    got = np.stack([np.asarray(s.req.embedding) for s in mine])
    want = np.stack([ref[s.target] for s in mine])
    gap = float(row_gaps(got, want, scale).max())
    return checks + [Check("emb_gap", gap, float(limits["emb_gap"]))], \
        len(mine)
