"""Feature shipping (dense, packed, resident, sharded) and host
neighborhood caches (see policy.py for the knobs)."""
from repro_torch.store.feature_store import (DenseFeatureShipper,
                                             DeviceFeatureStore,
                                             PackedFeatureShipper,
                                             ResidencySnapshot,
                                             build_feature_source)
from repro_torch.store.nbr_cache import (FrontierCache, NeighborhoodCache,
                                         SubgraphRowCache, nbr_key)
from repro_torch.store.policy import StorePolicy
from repro_torch.store.sharded import ShardedFeatureStore

__all__ = ["StorePolicy", "NeighborhoodCache", "SubgraphRowCache",
           "FrontierCache", "nbr_key", "PackedFeatureShipper",
           "DenseFeatureShipper", "DeviceFeatureStore", "ResidencySnapshot",
           "ShardedFeatureStore", "build_feature_source"]
