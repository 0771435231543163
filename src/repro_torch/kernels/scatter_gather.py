"""Edge-list scatter-gather aggregation: the CUDA kernels
``csrc/scatter_gather.cu`` and their plain PyTorch version.

    out[c, i] = sum_e [dst[c, e] == i] * w[c, e] * h[c, src[c, e]]

Replaces the TPU kernel ``scatter_gather_aggregate``
(src/repro/kernels/scatter_gather.py, ``_kernel``), which routes edges
through one-hot matmuls, with the semantics of its oracle
(``repro.kernels.ref.scatter_gather_aggregate_ref``). Bound on an H100:
bytes (2 FLOP per live edge and column). h and the output are float32 or
bfloat16 (as the reference takes them: loaded as fp32, summed in fp32,
rounded once on the store); w is float32. Two kernels, chosen by
``sg_variant`` from the shapes before launch:

- ``"sort"`` (E <= 65,536 and its shared memory fits at (N, E): every
  serving launch at N=256): one block per (c, tile of 128 columns, or 64
  or 32 where shared memory is short) stages its tile of h[c] in shared
  memory and sorts the live edges (w != 0) by destination there, stably,
  with 16-bit edge indices.
- ``"bucket"`` (the rest, e.g. forced sg at N=1024 with the Flickr-sized
  graph's 74,496 edge slots): the same stable sort with 32-bit indices
  into a scratch in device memory (one block a subgraph), then a second
  launch that gives each (destination row, 128 columns) to a warp reading
  h from device memory.

Both then sum each destination row's edges in edge order in registers
and write the row once: no atomics, the same result on every run, many
edges into one vertex summed exactly. Weight-0 edges (the padding) are
not walked, yet keep the oracle's 0 * h[src]: where such an edge's source
row holds inf or NaN in a column, its destination gets NaN there. Edges
with an index outside [0, N) are skipped.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the chosen kernel or raises. ``launches`` counts
launches (one a call), ``variant_launches`` each kernel's.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

VARIANTS = ("sort", "bucket")
SORT_MAX_EDGES = 65536      # the sort kernel's 16-bit edge indices
_SORT_WARPS = 16

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def sort_smem_bytes(N: int, E: int, block_cols: int) -> int:
    """Shared memory of one sort-kernel block (``Layout`` in the .cu): the
    h tile, 16 histograms of N ints, N + 1 starts, two N x 16-byte column
    masks, N flags, a counter and a 16-bit index per edge slot."""
    cnt = 4 * N * block_cols
    start = cnt + 4 * _SORT_WARPS * N
    bad = (start + 4 * (N + 1) + 15) & ~15
    idx = bad + 16 * N + 16 * N + 4 * N + 16
    return idx + ((2 * E + 15) & ~15)


def sort_block_cols(N: int, E: int) -> int:
    """Columns a sort-kernel block takes at (N, E): 128, 64 or 32, the
    widest whose shared memory fits a block; 0 where none does or E
    exceeds the 16-bit indices (the library's scatter_gather_block_cols
    must agree)."""
    if E > SORT_MAX_EDGES:
        return 0
    for bf in (128, 64, 32):
        if sort_smem_bytes(N, E, bf) <= build.MAX_SMEM:
            return bf
    return 0


def sg_variant(N: int, E: int) -> str:
    """The kernel that takes h [C,N,F] with E edge slots a subgraph."""
    return "sort" if sort_block_cols(N, E) else "bucket"


def scatter_gather_aggregate_ref(src, dst, w, h, **_):
    """Plain PyTorch version (``repro.kernels.ref.scatter_gather_
    aggregate_ref``): per subgraph, gather the source rows, scale by the
    edge weight and ``index_add_`` them at the destinations (fp32, cast
    back to h's dtype)."""
    C, E = src.shape
    _, N, F = h.shape
    off = (torch.arange(C, device=h.device) * N)[:, None]
    upd = h.float().reshape(C * N, F)[(src.long() + off).reshape(-1)] \
        * w.float().reshape(-1, 1)
    out = torch.zeros((C * N, F), dtype=torch.float32, device=h.device)
    out.index_add_(0, (dst.long() + off).reshape(-1), upd)
    return out.reshape(C, N, F).to(h.dtype)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _lib():
    lib = build.load("scatter_gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _SUFFIX.values():
        fn = getattr(lib, f"scatter_gather_sort_{dt}")
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"scatter_gather_bucket_{dt}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.scatter_gather_block_cols.argtypes = [i, i]
    lib.scatter_gather_block_cols.restype = i
    lib.scatter_gather_bucket_scratch_words.argtypes = [i, i, i, i]
    lib.scatter_gather_bucket_scratch_words.restype = ctypes.c_longlong
    for n, e in ((256, 18688), (256, 65537), (1024, 74496), (512, 40000)):
        if lib.scatter_gather_block_cols(n, e) != sort_block_cols(n, e):
            raise RuntimeError(f"scatter_gather: the library's block width "
                               f"at N={n}, E={e} is "
                               f"{lib.scatter_gather_block_cols(n, e)}, the "
                               f"wrapper's {sort_block_cols(n, e)}")
    return lib


def scatter_gather_aggregate(src, dst, w, h):
    """src/dst [C,E] int32 (padding edges carry w == 0 and any index in
    range); w [C,E] float32; h [C,N,F] float32 or bfloat16. Returns
    [C,N,F] in h's dtype."""
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
    if w.dtype != torch.float32 or h.dtype not in _SUFFIX:
        raise TypeError(f"scatter_gather_aggregate: w must be float32 and h "
                        f"float32 or bfloat16, got {w.dtype} and {h.dtype}")
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
    variant = sg_variant(N, E)
    lib = _lib()
    dt = _SUFFIX[h.dtype]
    out = torch.empty((C, N, F), dtype=h.dtype, device=dev)
    ptrs = (src.data_ptr(), dst.data_ptr(), w.data_ptr(), h.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if variant == "sort":
            err = getattr(lib, f"scatter_gather_sort_{dt}")(
                *ptrs, C, N, E, F, stream)
        else:
            # freed on return: the caching allocator may hand it out again
            # at once, but only to work queued behind these kernels on
            # this stream
            scratch = torch.empty(
                lib.scatter_gather_bucket_scratch_words(C, N, E, F),
                dtype=torch.int32, device=dev)
            err = getattr(lib, f"scatter_gather_bucket_{dt}")(
                *ptrs, scratch.data_ptr(), C, N, E, F, stream)
    if err:
        raise RuntimeError(f"scatter_gather_aggregate: {variant} kernel "
                           f"launch failed (cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
        variant_launches[variant] += 1
    return out
