"""ServingConfig — the one typed knob surface for a serving deployment.

The PyTorch counterpart of ``repro.core.config``, with the planes this
package has ported so far:

  * device program:  device, batch_size, mode, impl, e_pad, seed
  * host pipeline:   num_threads, depth (triple buffering),
                     max_inflight (backpressure), max_wait_s (the
                     server's micro-batch deadline)
  * store:           ``StorePolicy`` (dense, packed or device-resident
                     features; local neighborhood and subgraph-row
                     caches)

``device`` defaults to ``"cuda"`` and ``impl`` to ``"cuda"`` (the hand
kernels), so a default deployment on a card always runs the kernels; a
CUDA device with no card raises, and nothing continues on the CPU
unasked. The reference's other planes — ``trace``, ``telemetry``,
``dispatch``, ``precompute`` and a ``transport`` other than ``"local"`` —
are not ported yet: setting one raises NotImplementedError naming it,
and so does the sharded feature store.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.program import IMPLS
from repro_torch.devices import resolve
from repro_torch.store.policy import StorePolicy

UNPORTED_PLANES = ("trace", "telemetry", "dispatch", "precompute")


@dataclass(frozen=True)
class ServingConfig:
    """Per-deployment serving configuration (see module docstring)."""
    # device program
    device: str = "cuda"               # torch device of the program
    batch_size: int = 64
    mode: str = "auto"                 # per-op mux: auto | dense | sg
    impl: str = "cuda"                 # kernel substrate: torch | cuda
    seed: int = 0                      # param init when params=None
    e_pad: Optional[int] = None        # edge budget; None = derive
    # store
    store: StorePolicy = field(default_factory=StorePolicy)
    # host pipeline
    num_threads: int = 8
    depth: int = 3                     # paper's triple buffering
    max_inflight: Optional[int] = None  # backpressure; None = 2 * depth
    max_wait_s: float = 0.005          # micro-batcher deadline (server)
    # planes of the reference not ported yet: anything but the default
    # raises NotImplementedError
    transport: str = "local"
    trace: Optional[object] = None
    precompute: Optional[object] = None
    telemetry: Optional[object] = None
    dispatch: Optional[object] = None

    def __post_init__(self):
        for name in UNPORTED_PLANES:
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"ServingConfig.{name}: this plane is not ported to "
                    f"repro_torch yet (leave it None)")
        if self.transport != "local":
            raise NotImplementedError(
                f"ServingConfig.transport={self.transport!r}: only the "
                f"local transport is ported to repro_torch")
        if not isinstance(self.store, StorePolicy):
            raise TypeError(
                f"store must be a StorePolicy, got "
                f"{type(self.store).__name__}")
        if self.store.features == "sharded":
            raise NotImplementedError(
                "StorePolicy.features='sharded': the sharded feature store "
                "is not ported to repro_torch yet (ROADMAP queue 1, item 7; "
                "use 'dense', 'packed' or 'resident')")
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


__all__ = ["ServingConfig"]
