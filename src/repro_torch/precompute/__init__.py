"""Offline layer-major precompute tier + hybrid serving, in PyTorch.

Decoupled models make propagation a pure function of the graph: S^K X can
be computed ONCE, layer-major, over the full graph; serving a precomputed
vertex is then a row lookup, with no PPR push and no subgraph build. This
package holds the offline propagation (propagate: its Aggregates on the
scatter-gather kernel under impl="cuda"), the freshness-tracked embedding
table (tier), the hybrid router + refresh workers (manager), artifact
persistence (artifact, build), and the ``ServingConfig(precompute=...)``
knobs (config). The PyTorch counterpart of ``repro.precompute``.
"""
from repro_torch.precompute.artifact import (PrecomputeArtifactError,
                                             load_artifact, save_artifact)
from repro_torch.precompute.config import PrecomputeConfig
from repro_torch.precompute.manager import PrecomputeManager, TierStage
from repro_torch.precompute.propagate import (PrecomputeError, agg_hops,
                                              check_precomputable,
                                              dependency_closure,
                                              layer_major_embeddings)
from repro_torch.precompute.tier import EmbeddingTier

__all__ = ["PrecomputeConfig", "PrecomputeError",
           "PrecomputeArtifactError", "EmbeddingTier",
           "PrecomputeManager", "TierStage", "layer_major_embeddings",
           "dependency_closure", "check_precomputable", "agg_hops",
           "save_artifact", "load_artifact"]
