"""Feature shipping and host neighborhood caches (see policy.py for the
knobs). The sharded feature store is not ported yet."""
from repro_torch.store.feature_store import (DenseFeatureShipper,
                                             DeviceFeatureStore,
                                             PackedFeatureShipper,
                                             ResidencySnapshot,
                                             build_feature_source)
from repro_torch.store.nbr_cache import (FrontierCache, NeighborhoodCache,
                                         SubgraphRowCache, nbr_key)
from repro_torch.store.policy import StorePolicy

__all__ = ["StorePolicy", "NeighborhoodCache", "SubgraphRowCache",
           "FrontierCache", "nbr_key", "PackedFeatureShipper",
           "DenseFeatureShipper", "DeviceFeatureStore", "ResidencySnapshot",
           "build_feature_source"]
