"""The versioned key schema behind the scheduler's summary.

The PyTorch counterpart of ``repro.core.report_schema``, limited to the
sections this package emits: ``latency.*``, ``stages.*`` and ``store.*``
keep the reference's names, so a dashboard reads both packages alike. The
reference's ``shards``/``rpc``/``trace``/``precompute``/``telemetry``/
``dispatch`` sections belong to planes not ported yet.
"""
from __future__ import annotations

SCHEMA_VERSION = 5


def stages_section(stats) -> dict:
    return {"times": {k: round(v, 6)
                      for k, v in stats.stage_times.items()},
            "overlap": round(stats.overlap_fraction, 3),
            "batches": stats.n_batches,
            "build_hit_rate": round(stats.build_hit_rate, 4),
            "batch_edges": round(stats.batch_edges, 2)}


def store_section(stats) -> dict:
    """The scheduler-side transfer counters of ``store.*`` (the engine
    merges its store-subsystem state into the same namespace)."""
    return {"bytes_shipped": stats.bytes_shipped,
            "bytes_dense": stats.bytes_dense,
            "transfer_ratio": round(stats.transfer_ratio, 4),
            "cache_hit_rate": round(stats.cache_hit_rate, 4),
            "dedup_ratio": stats.last_dedup_ratio}


def scheduler_summary(stats) -> dict:
    """The nested summary a ``SchedulerStats`` emits."""
    return {"schema_version": SCHEMA_VERSION,
            "latency": {"t_wall": stats.t_wall,
                        "t_host": stats.t_host_total,
                        "t_device": stats.t_device_total,
                        "t_init": stats.t_initialization},
            "stages": stages_section(stats),
            "store": store_section(stats)}


__all__ = ["SCHEMA_VERSION", "scheduler_summary",
           "stages_section", "store_section"]
