"""ServingConfig — the one typed knob surface for a serving deployment.

The PyTorch counterpart of ``repro.core.config``, with every plane of the
reference:

  * device program:  device, batch_size, mode, impl, e_pad, seed
  * host pipeline:   num_threads, depth (triple buffering),
                     max_inflight (backpressure), max_wait_s (the
                     server's micro-batch deadline)
  * store:           ``StorePolicy`` (dense, packed, device-resident or
                     sharded features; local neighborhood and subgraph-row
                     caches)
  * observability:   ``trace`` (an ``obs.TraceConfig``: per-batch spans,
                     histograms, the flight recorder and the sampled
                     calibration pass)
  * dispatch:        ``dispatch`` (a ``core.dispatch.DispatchConfig``:
                     per-batch measured-cost dense/sg dispatch, the
                     bounded variant cache, kernel block autotune)
  * precompute:      ``precompute`` (a ``precompute.PrecomputeConfig``:
                     the offline layer-major embedding tier and hybrid
                     routing)
  * telemetry:       ``telemetry`` (an ``obs.TelemetryConfig``: windowed
                     metrics, Prometheus exposition, SLO burn rates and
                     the regression watchdog)
  * transport:       where Select/Build run —
      transport="local"   in-process stages (the default)
      transport="inproc"  a private GraphHostService behind the loopback
                          transport: full wire codec, one process
      transport="socket"  TCP to ``endpoints`` graph hosts, routed
                          round-robin or partition-affine with per-call
                          timeout + bounded retry

``device`` defaults to ``"cuda"`` and ``impl`` to ``"cuda"`` (the hand
kernels), so a default deployment on a card always runs the kernels; a
CUDA device with no card raises, and nothing continues on the CPU
unasked. Graph hosts are CPU processes: the transport moves Select and
Build off the device host, while Pack and the program stay on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.core.program import IMPLS
from repro_torch.devices import resolve
from repro_torch.store.policy import StorePolicy

TRANSPORT_MODES = ("local", "inproc", "socket")
ROUTING_MODES = ("round_robin", "affine")


@dataclass(frozen=True)
class ServingConfig:
    """Per-deployment serving configuration (see module docstring)."""
    # device program
    device: str = "cuda"               # torch device of the program
    batch_size: int = 64
    mode: str = "auto"                 # per-op mux: auto | dense | sg
    impl: str = "cuda"                 # kernel substrate: torch | cuda
    seed: int = 0                      # param init when params=None
    e_pad: Optional[int] = None        # edge budget; None = none (layout derived)
    # store
    store: StorePolicy = field(default_factory=StorePolicy)
    # host pipeline
    num_threads: int = 8
    depth: int = 3                     # paper's triple buffering
    max_inflight: Optional[int] = None  # backpressure; None = 2 * depth
    max_wait_s: float = 0.005          # micro-batcher deadline (server)
    # transport: where Select/Build run
    transport: str = "local"
    endpoints: Tuple[str, ...] = ()    # "host:port" graph hosts (socket)
    rpc_timeout_s: float = 30.0        # per-call deadline
    rpc_retries: int = 2               # extra attempts on OTHER hosts
    rpc_concurrency: int = 4           # in-flight calls per deployment
    routing: str = "round_robin"       # round_robin | affine
    # observability: None (default) = tracing off, zero-cost; a
    # TraceConfig enables per-ticket spans + histograms (obs package)
    trace: Optional[object] = None
    # dispatch: None (default) = static mode selection at engine init; a
    # DispatchConfig enables per-batch measured-cost dense/sg dispatch.
    # Only meaningful with mode="auto" — a forced mode pins the mux.
    dispatch: Optional[object] = None
    # precompute: None (default) = pure online serving; a
    # PrecomputeConfig builds (or loads) the offline embedding tier and
    # routes tier-fresh targets around the host pipeline
    precompute: Optional[object] = None
    # telemetry: None (default) = metrics off, zero-cost; a
    # TelemetryConfig enables windowed metrics + Prometheus exposition
    # + SLO burn rates + the regression watchdog (obs package)
    telemetry: Optional[object] = None

    def __post_init__(self):
        if self.trace is not None:
            from repro_torch.obs.trace import TraceConfig
            if not isinstance(self.trace, TraceConfig):
                raise TypeError(
                    f"trace must be an obs.TraceConfig or None, got "
                    f"{type(self.trace).__name__}")
        if self.dispatch is not None:
            from repro_torch.core.dispatch import DispatchConfig
            if not isinstance(self.dispatch, DispatchConfig):
                raise TypeError(
                    f"dispatch must be a core.DispatchConfig or None, "
                    f"got {type(self.dispatch).__name__}")
        if self.precompute is not None:
            from repro_torch.precompute.config import PrecomputeConfig
            if not isinstance(self.precompute, PrecomputeConfig):
                raise TypeError(
                    f"precompute must be a precompute.PrecomputeConfig or "
                    f"None, got {type(self.precompute).__name__}")
        if self.telemetry is not None:
            from repro_torch.obs.metrics import TelemetryConfig
            if not isinstance(self.telemetry, TelemetryConfig):
                raise TypeError(
                    f"telemetry must be an obs.TelemetryConfig or None, "
                    f"got {type(self.telemetry).__name__}")
        if not isinstance(self.store, StorePolicy):
            raise TypeError(
                f"store must be a StorePolicy, got "
                f"{type(self.store).__name__}")
        if self.impl not in IMPLS:
            raise ValueError(f"impl={self.impl!r}, expected one of {IMPLS}")
        if self.mode not in ("auto", "dense", "sg"):
            raise ValueError(f"mode={self.mode!r}, expected auto | dense | "
                             f"sg")
        resolve(self.device)            # cuda with no card raises
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.num_threads < 1:
            raise ValueError("num_threads must be >= 1")
        if self.depth < 1:
            raise ValueError("depth must be >= 1")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1 (or None)")
        if self.max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        if self.transport not in TRANSPORT_MODES:
            raise ValueError(f"transport={self.transport!r}, expected "
                             f"one of {TRANSPORT_MODES}")
        if self.routing not in ROUTING_MODES:
            raise ValueError(f"routing={self.routing!r}, expected one "
                             f"of {ROUTING_MODES}")
        if not isinstance(self.endpoints, tuple):
            object.__setattr__(self, "endpoints", tuple(self.endpoints))
        if self.transport == "socket" and not self.endpoints:
            raise ValueError(
                "transport='socket' needs at least one 'host:port' in "
                "endpoints")
        if self.endpoints and self.transport != "socket":
            raise ValueError(
                f"endpoints are only meaningful with transport='socket' "
                f"(got transport={self.transport!r})")
        if self.rpc_timeout_s <= 0:
            raise ValueError("rpc_timeout_s must be > 0")
        if self.rpc_retries < 0:
            raise ValueError("rpc_retries must be >= 0")
        if self.rpc_concurrency < 1:
            raise ValueError("rpc_concurrency must be >= 1")

    @property
    def remote(self) -> bool:
        """Whether Select/Build run behind a transport."""
        return self.transport != "local"

    def describe(self) -> dict:
        d = {"device": self.device, "batch_size": self.batch_size,
             "mode": self.mode, "impl": self.impl, "depth": self.depth,
             "num_threads": self.num_threads,
             "transport": self.transport}
        if self.trace is not None:
            d["trace"] = self.trace.describe()
        if self.dispatch is not None:
            d["dispatch"] = self.dispatch.describe()
        if self.precompute is not None:
            d["precompute"] = self.precompute.describe()
        if self.telemetry is not None:
            d["telemetry"] = self.telemetry.describe()
        if self.remote:
            d.update(endpoints=list(self.endpoints) or ["inproc"],
                     rpc_timeout_s=self.rpc_timeout_s,
                     rpc_retries=self.rpc_retries,
                     routing=self.routing)
        return d


__all__ = ["ServingConfig", "TRANSPORT_MODES", "ROUTING_MODES"]
