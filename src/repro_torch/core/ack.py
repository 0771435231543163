"""Adaptive Computation Kernel (ACK) — execution-mode dispatch (paper §4.2).

Copied verbatim from the JAX package so that ``mode="auto"`` decides
exactly as the reference does. The cost model below still prices the sg
mode as the reference's one-hot routing matmuls (4*E*N*f); the CUDA
scatter-gather kernel of this package walks the edge list instead, so a
cost model for the GPU kernels is later work.

Mode economics per layer (f features, N vertices, E edges):
    dense FA FLOPs  = 2 N^2 f        (adjacency densified -> matmul)
    sg    FA FLOPs  = 2 E f          (+ 4 N_blk E f one-hot routing matmuls)
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AckDecision:
    mode: str            # "dense" | "sg"
    dense_flops: float
    sg_flops: float
    reason: str


def choose_mode(n: int, avg_edges: float, f: int,
                force: str | None = None) -> AckDecision:
    """Static mode mux. ``avg_edges`` is the mean induced-subgraph edge
    count for the workload (host knows it after INI)."""
    dense = 2.0 * n * n * f
    # the reference's SG pays the one-hot routing matmuls: ~2 * EB-blocked matmuls
    # of [E,N]x[N,f] and [N,E]x[E,f] => 4*E*N*f, dominating 2*E*f.
    sg = 4.0 * avg_edges * n * f
    if force in ("dense", "sg"):
        return AckDecision(force, dense, sg, "forced")
    mode = "dense" if dense <= sg else "sg"
    # break-even: dense <= sg  <=>  2*N^2*f <= 4*E*N*f  <=>  N <= 2E —
    # report the quantities actually compared
    return AckDecision(mode, dense, sg,
                       f"N={n} vs 2E={2*avg_edges:.0f}")
