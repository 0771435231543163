"""Edge-list scatter-gather aggregation: the CUDA kernel
``csrc/scatter_gather.cu`` and its plain PyTorch version.

    out[c, i] = sum_e [dst[c, e] == i] * w[c, e] * h[c, src[c, e]]

Replaces the TPU kernel ``scatter_gather_aggregate``
(src/repro/kernels/scatter_gather.py, ``_kernel``), which routes edges
through one-hot matmuls, with the semantics of its oracle
(``repro.kernels.ref.scatter_gather_aggregate_ref``). Bound on an H100:
bytes (2 FLOP per live edge and column). One block per (c, tile of 128
columns, or 64 or 32 where shared memory is short) stages its tile of h[c]
in shared memory and sorts the live edges (w != 0) by destination there,
stably, then gives each destination row to one warp, which sums the row's
edges in edge order in registers and writes the row once: no atomics, the
same result on every run, many edges into one vertex summed exactly.
Weight-0 edges (the padding) are not walked, yet keep the oracle's
0 * h[src]: where such an edge's source row holds inf or NaN in a column,
its destination gets NaN there. Edges with an index outside [0, N) are
skipped.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

MAX_EDGES = 65536           # the kernel sorts 16-bit edge indices

launches = 0
_count_lock = threading.Lock()


def scatter_gather_aggregate_ref(src, dst, w, h, **_):
    """Plain PyTorch version (``repro.kernels.ref.scatter_gather_
    aggregate_ref``): per subgraph, gather the source rows, scale by the
    edge weight and ``index_add_`` them at the destinations."""
    C, E = src.shape
    _, N, F = h.shape
    off = (torch.arange(C, device=h.device) * N)[:, None]
    upd = h.float().reshape(C * N, F)[(src.long() + off).reshape(-1)] \
        * w.float().reshape(-1, 1)
    out = torch.zeros((C * N, F), dtype=torch.float32, device=h.device)
    out.index_add_(0, (dst.long() + off).reshape(-1), upd)
    return out.reshape(C, N, F).to(h.dtype)


def _lib():
    lib = build.load("scatter_gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scatter_gather_aggregate_f32.argtypes = [p, p, p, p, p,
                                                 i, i, i, i, p]
    lib.scatter_gather_aggregate_f32.restype = i
    lib.scatter_gather_block_cols.argtypes = [i, i]
    lib.scatter_gather_block_cols.restype = i
    return lib


def scatter_gather_aggregate(src, dst, w, h):
    """src/dst [C,E] int32 (padding edges carry w == 0 and any index in
    range); w [C,E] float32; h [C,N,F] float32. Returns [C,N,F]."""
    if src.dim() != 2 or h.dim() != 3:
        raise ValueError(f"scatter_gather_aggregate: src must be [C,E] and "
                         f"h [C,N,F], got {tuple(src.shape)} and "
                         f"{tuple(h.shape)}")
    C, E = src.shape
    _, N, F = h.shape
    if h.shape[0] != C or tuple(dst.shape) != (C, E) \
            or tuple(w.shape) != (C, E):
        raise ValueError(f"scatter_gather_aggregate: shapes src "
                         f"{tuple(src.shape)}, dst {tuple(dst.shape)}, w "
                         f"{tuple(w.shape)}, h {tuple(h.shape)} disagree")
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError("scatter_gather_aggregate: src/dst must be int32")
    if w.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError("scatter_gather_aggregate: w/h must be float32")
    dev = h.device
    if any(t.device != dev for t in (src, dst, w)):
        raise ValueError("scatter_gather_aggregate: inputs on different "
                         "devices")
    if dev.type == "cpu":
        return scatter_gather_aggregate_ref(src, dst, w, h)
    if dev.type != "cuda":
        raise ValueError(f"scatter_gather_aggregate: unsupported device "
                         f"{dev}")
    if not all(t.is_contiguous() for t in (src, dst, w, h)):
        raise ValueError("scatter_gather_aggregate: inputs must be "
                         "contiguous")
    if E > MAX_EDGES:
        raise ValueError(f"scatter_gather_aggregate: E={E} edge slots, the "
                         f"kernel takes at most {MAX_EDGES}")
    lib = _lib()
    if not lib.scatter_gather_block_cols(N, E):
        raise ValueError(f"scatter_gather_aggregate: N={N}, E={E} need "
                         f"more shared memory than a block has, even at 32 "
                         f"columns a block")
    out = torch.empty((C, N, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scatter_gather_aggregate_f32(
            src.data_ptr(), dst.data_ptr(), w.data_ptr(), h.data_ptr(),
            out.data_ptr(), C, N, E, F, stream)
    if err:
        raise RuntimeError(f"scatter_gather_aggregate: CUDA launch failed "
                           f"(cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
    return out
