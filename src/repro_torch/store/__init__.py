"""Feature shipping and host neighborhood caches (see policy.py for the
knobs). Only the dense and packed feature strategies are ported."""
from repro_torch.store.feature_store import (DenseFeatureShipper,
                                             PackedFeatureShipper,
                                             build_feature_source)
from repro_torch.store.nbr_cache import (FrontierCache, NeighborhoodCache,
                                         SubgraphRowCache, nbr_key)
from repro_torch.store.policy import StorePolicy

__all__ = ["StorePolicy", "NeighborhoodCache", "SubgraphRowCache",
           "FrontierCache", "nbr_key", "PackedFeatureShipper",
           "DenseFeatureShipper", "build_feature_source"]
