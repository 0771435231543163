"""The versioned key schema behind the scheduler's summary.

The PyTorch counterpart of ``repro.core.report_schema``: ``latency.*``,
``stages.*``, ``store.*``, ``shards.*`` (sharded feature stores),
``rpc.*`` (multi-host transports), ``trace.*`` (traced deployments),
``precompute.*`` (tiered ones), ``telemetry.*`` (metered ones) and
``dispatch.*`` (adaptively dispatched ones) keep the reference's names, so
a dashboard reads both packages alike (``SCHEMA``, the reference's key
map). ``trace`` and ``dispatch`` add one key the reference lacks,
``explore_failures``: the calibration, warm-up and autotune passes that
raised, which the reference swallows. ``trace`` adds one more on a card,
``gpu_anchor_rtt_us``: the round trip that ties the ``gpu.*`` spans to
the host's clock (``obs.Tracer.anchor_gpu``).
"""
from __future__ import annotations

from typing import Optional

SCHEMA_VERSION = 5

# the documented key map of the sections this package emits
SCHEMA = {
    "latency": ("t_wall", "t_host", "t_device", "t_init",
                "p50", "p90", "p99", "mean", "batch_mean", "n", "hist"),
    "stages": ("times", "overlap", "batches", "build_hit_rate",
               "batch_edges"),
    "store": ("bytes_shipped", "bytes_dense", "transfer_ratio",
              "cache_hit_rate", "dedup_ratio", "policy", "features",
              "nbr_cache", "subgraph_cache", "auto_repins",
              "graph_hosts"),
    "shards": ("bytes", "balance"),
    "rpc": ("calls", "bytes_out", "bytes_in", "retries", "timeouts",
            "errors", "wall_s", "remote_s", "wire_s"),
    "trace": ("enabled", "sample_every", "ring_capacity", "flight_k",
              "calibrate_every", "tickets_traced", "spans",
              "spans_dropped", "remote_spans", "host", "hists",
              "flight", "clock_sync", "calibration", "explore_failures",
              "gpu_anchor_rtt_us"),
    "precompute": ("enabled", "resident", "fresh", "hits", "misses",
                   "hit_rate", "demotions", "promotions",
                   "refresh_chunks", "refresh_backlog",
                   "refresh_errors", "tier_bytes", "generation",
                   "builds"),
    "telemetry": ("enabled", "host", "window_s", "windows", "series",
                  "counters", "gauges", "hists", "slo", "watchdog",
                  "evaluations", "events"),
    "dispatch": ("enabled", "policy", "impl", "mux_sites", "decisions",
                 "sources", "warmup", "variants", "blocks",
                 "table_cells", "table_passes", "artifact",
                 "explore_failures"),
}


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


def shards_section(stats) -> Optional[dict]:
    """The ``shards.*`` section: cumulative bytes shipped per feature-store
    shard and their max/mean balance (None when the deployment is not
    sharded — the section is omitted)."""
    if not stats.shard_bytes:
        return None
    return {"bytes": list(stats.shard_bytes),
            "balance": round(stats.shard_balance, 4)}


def rpc_section(stats) -> Optional[dict]:
    """The ``rpc.*`` section of a multi-host deployment (None before its
    first remote call — the section is omitted)."""
    if not stats.rpc_calls:
        return None
    return {"calls": stats.rpc_calls,
            "bytes_out": stats.rpc_bytes_out,
            "bytes_in": stats.rpc_bytes_in,
            "retries": stats.rpc_retries,
            "timeouts": stats.rpc_timeouts,
            "errors": stats.rpc_errors,
            "wall_s": round(stats.t_rpc_wall, 6),
            "remote_s": round(stats.t_rpc_remote, 6),
            "wire_s": round(stats.t_rpc_wire, 6)}


def trace_section(tracer, calibration=None) -> Optional[dict]:
    """The ``trace.*`` section of a traced deployment (None when tracing
    is off — the section is omitted)."""
    if tracer is None:
        return None
    d = tracer.report()
    if calibration is not None and len(calibration):
        d["calibration"] = calibration.to_dict()
    return d


def precompute_section(manager) -> dict:
    """The ``precompute.*`` section of a tiered deployment;
    ``{"enabled": False}`` when the deployment has no embedding tier."""
    if manager is None:
        return {"enabled": False}
    return manager.report()


def telemetry_section(telemetry) -> Optional[dict]:
    """The ``telemetry.*`` section of a metered deployment (None when
    telemetry is off — the section is omitted, like ``trace``)."""
    if telemetry is None:
        return None
    return telemetry.report()


def dispatch_section(engine) -> Optional[dict]:
    """The ``dispatch.*`` section of an adaptively dispatched deployment
    (None when ServingConfig(dispatch=...) is unset — omitted, like
    ``trace``)."""
    rep = getattr(engine, "dispatch_report", None)
    if rep is None:
        return None
    return rep()


def scheduler_summary(stats) -> dict:
    """The nested summary a ``SchedulerStats`` emits."""
    d = {"schema_version": SCHEMA_VERSION,
         "latency": {"t_wall": stats.t_wall,
                     "t_host": stats.t_host_total,
                     "t_device": stats.t_device_total,
                     "t_init": stats.t_initialization},
         "stages": stages_section(stats),
         "store": store_section(stats)}
    shards = shards_section(stats)
    if shards is not None:
        d["shards"] = shards
    rpc = rpc_section(stats)
    if rpc is not None:
        d["rpc"] = rpc
    return d


__all__ = ["SCHEMA_VERSION", "SCHEMA", "scheduler_summary",
           "stages_section", "store_section", "shards_section",
           "rpc_section", "trace_section", "precompute_section",
           "telemetry_section", "dispatch_section"]
