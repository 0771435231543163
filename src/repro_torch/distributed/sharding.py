"""Devices behind the feature store's logical shards.

The PyTorch counterpart of ``repro.distributed.sharding.shard_devices``.
The reference file's mesh, activation and parameter sharding rules belong
to the LM substrate (ROADMAP queue 1, item 14.8) and are not ported.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.devices import resolve


def shard_devices(num_shards: int, device="cuda") -> List[torch.device]:
    """One ``torch.device`` per logical feature-store shard.

    On a CUDA ``device``: ``cuda:0 .. cuda:k-1`` when the host has at least
    ``num_shards`` cards; otherwise the shards are simulated, every table
    on ``device`` itself but each under its own budget and placement (the
    store's ``simulated`` flag reports which regime is active). On the CPU:
    ``cpu`` k times. Shard 0 is the target: the device the engine's program
    runs on."""
    dev = resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= num_shards \
            and (dev.index or 0) == 0:
        return [torch.device("cuda", i) for i in range(num_shards)]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * num_shards


__all__ = ["shard_devices"]
