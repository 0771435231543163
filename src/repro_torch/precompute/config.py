"""PrecomputeConfig — the offline-tier knobs on ``ServingConfig``.

``ServingConfig(precompute=PrecomputeConfig(...))`` turns the hybrid
serving tier on for a deployment: the engine builds (or loads) the
full-graph layer-major embedding table at construction and serves
tier-fresh targets from it, falling back to the online PPR pipeline for
cold / recently-updated vertices (see repro_torch.precompute). A copy of
``repro.precompute.config``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class PrecomputeConfig:
    """Offline embedding-tier configuration.

    models:          model kinds the tier applies to (None = any kind
                     whose lowered program is precomputable — pure
                     Aggregate/Residual/Transform layers + Readout[target])
    chunk_size:      destination vertices per offline propagation chunk —
                     bounds working memory at one hop x chunk and sets the
                     refresh granularity
    refresh_workers: background threads re-promoting demoted vertices
    budget_bytes:    embedding-table byte cap; None = whole graph
                     resident. Over-budget vertices (lowest degree first)
                     stay permanently cold and serve online.
    artifact:        path of a ``repro_torch.precompute.build`` artifact
                     to load instead of building at engine construction
                     (validated against the live graph/model — see
                     artifact.py)
    auto_refresh:    schedule refresh chunks as soon as vertices demote;
                     False = accumulate backlog until ``drain()`` (tests /
                     controlled maintenance windows)
    """
    models: Optional[Tuple[str, ...]] = None
    chunk_size: int = 2048
    refresh_workers: int = 1
    budget_bytes: Optional[int] = None
    artifact: Optional[str] = None
    auto_refresh: bool = True

    def __post_init__(self):
        if self.models is not None and not isinstance(self.models, tuple):
            object.__setattr__(self, "models", tuple(self.models))
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size={self.chunk_size}, expected >= 1")
        if self.refresh_workers < 1:
            raise ValueError(
                f"refresh_workers={self.refresh_workers}, expected >= 1")
        if self.budget_bytes is not None and self.budget_bytes < 0:
            raise ValueError(
                f"budget_bytes={self.budget_bytes}, expected >= 0 or None")

    def describe(self) -> dict:
        return {"models": list(self.models) if self.models else None,
                "chunk_size": self.chunk_size,
                "refresh_workers": self.refresh_workers,
                "budget_bytes": self.budget_bytes,
                "artifact": self.artifact,
                "auto_refresh": self.auto_refresh}
