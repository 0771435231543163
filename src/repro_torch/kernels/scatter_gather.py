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
  serving launch at N=256): one block per (c, tile of 128, 64 or 32
  columns: ``sort_block_cols``) stages its tile of h[c] in shared memory
  and sorts the live edges (w != 0) by destination there, stably, with
  16-bit edge indices.
- ``"bucket"`` (the rest, e.g. forced sg at N=1024 with the Flickr-sized
  graph's 74,496 edge slots, and the offline build's chunks): the same
  stable sort spread over many blocks (a block per tile of
  ``BUCKET_TILE`` edge slots counts, a scan gives each tile its offset in
  each destination's bucket, a block per tile places its edges), then a
  warp per (destination row, 128 columns), or per 32 columns for a row of
  ``BUCKET_HUB`` live edges or more, reading h through a ring in shared
  memory. Its output has ``n_out`` rows: destinations at or past
  ``n_out`` are dropped, as ``segment_sum(num_segments=n_out)`` drops
  them.

Both then sum each destination row's edges in edge order in registers
and write the row once: no atomics, the same result on every run, many
edges into one vertex summed exactly. Weight-0 edges (the padding) are
not walked, yet keep the oracle's 0 * h[src]: where such an edge's source
row holds inf or NaN in a column, its destination gets NaN there. Edges
with a source outside [0, N) or a destination outside [0, n_out) are
skipped.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the chosen kernel or raises. ``launches`` counts
launches (one a call), ``variant_launches`` each kernel's,
``width_launches`` the sort kernel's by columns a block,
``caller_launches`` those of calls that name a ``caller`` and
``shape_launches`` them by (variant, C, N, E, F).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_analysis

VARIANTS = ("sort", "bucket")
SORT_MAX_EDGES = 65536      # the sort kernel's 16-bit edge indices
# the sort kernel's columns a block (its template's V = 4, 2, 1): the
# port's counterpart of the reference's BLOCK_E_CANDIDATES for autotune.
# Every lane sums its columns over its destination's edges in sorted-edge
# order whatever the width, so the width never changes a result
BLOCK_COLS_CANDIDATES = (128, 64, 32)
_SORT_WARPS = 16
BUCKET_TILE = 2048          # the bucket kernel's edge slots a tile
BUCKET_HUB = 512            # live in-edges from which it splits a row finer

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
width_launches = dict.fromkeys(BLOCK_COLS_CANDIDATES, 0)
caller_launches: dict = {}
# launches by (variant, C, N, E, F): the shapes a roofline prices
shape_launches: dict = {}
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


def sort_block_cols(N: int, E: int, F: int = BLOCK_COLS_CANDIDATES[0]
                    ) -> int:
    """Columns a sort-kernel block takes by default at (N, E) for F
    columns: 128, 64 or 32, the narrowest that still covers F in one tile
    (a narrower block stages less and more blocks share an SM; the sg
    softmax's 64-wide heads take 64), capped at the widest whose shared
    memory fits a block; 0 where none fits or E exceeds the 16-bit indices
    (the library's scatter_gather_block_cols must agree)."""
    fit = [bc for bc in BLOCK_COLS_CANDIDATES if sort_block_fits(N, E, bc)]
    if not fit:
        return 0
    covering = [bc for bc in fit if bc >= F]
    return covering[-1] if covering else fit[0]


def sort_block_fits(N: int, E: int, block_cols: int) -> bool:
    """Whether the sort kernel takes (N, E) at ``block_cols`` columns a
    block: a candidate width whose shared memory fits, E within the 16-bit
    indices."""
    return (block_cols in BLOCK_COLS_CANDIDATES and E <= SORT_MAX_EDGES
            and sort_smem_bytes(N, E, block_cols) <= build.MAX_SMEM)


def sg_variant(N: int, E: int) -> str:
    """The kernel that takes h [C,N,F] with E edge slots a subgraph."""
    return "sort" if sort_block_cols(N, E) else "bucket"


def scatter_gather_aggregate_ref(src, dst, w, h, n_out=None, **_):
    """Plain PyTorch version (``repro.kernels.ref.scatter_gather_
    aggregate_ref``, and ``segment_sum(num_segments=n_out)``): per
    subgraph, gather the source rows, scale by the edge weight and
    ``index_add_`` them at the destinations (fp32, cast back to h's
    dtype). Returns [C, n_out, F] (``n_out`` None: N). Edges with a source
    outside [0, N) or a destination outside [0, n_out) add into one
    spare row that is dropped, as the kernels skip them."""
    C, E = src.shape
    _, N, F = h.shape
    n = N if n_out is None else n_out
    s, d = src.long(), dst.long()
    ok = (s >= 0) & (s < N) & (d >= 0) & (d < n)
    spare = C * n
    rows = h.float().reshape(C * N, F)
    if N == 0:
        rows = rows.new_zeros(1, F)
    at = torch.arange(C, device=h.device)[:, None]
    upd = rows[torch.where(ok, s + at * N, 0).reshape(-1)] \
        * w.float().reshape(-1, 1)
    out = torch.zeros((spare + 1, F), dtype=torch.float32, device=h.device)
    out.index_add_(0, torch.where(ok, d + at * n, spare).reshape(-1), upd)
    return out[:spare].reshape(C, n, F).to(h.dtype)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_typed = None       # the library whose argument types are set and checked


def _lib():
    """The kernels' library, its functions' argument types set and its
    constants checked against the wrapper's once a library (ctypes checks
    argument types on every call; setting them per call cost host
    time)."""
    global _typed
    lib = build.load("scatter_gather")
    if lib is _typed:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _SUFFIX.values():
        fn = getattr(lib, f"scatter_gather_sort_{dt}")
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"scatter_gather_bucket_{dt}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    lib.scatter_gather_block_cols.argtypes = [i, i, i]
    lib.scatter_gather_block_cols.restype = i
    lib.scatter_gather_bucket_scratch_words.argtypes = [i, i, i, i, i]
    lib.scatter_gather_bucket_scratch_words.restype = ctypes.c_longlong
    for n, e, f in ((256, 18688, 512), (256, 18944, 68), (256, 18944, 64),
                    (256, 18944, 1), (256, 65537, 512), (1024, 74496, 256),
                    (512, 40000, 512), (512, 40000, 16)):
        if lib.scatter_gather_block_cols(n, e, f) != sort_block_cols(n, e, f):
            raise RuntimeError(f"scatter_gather: the library's block width "
                               f"at N={n}, E={e}, F={f} is "
                               f"{lib.scatter_gather_block_cols(n, e, f)}, "
                               f"the wrapper's {sort_block_cols(n, e, f)}")
    got = (lib.scatter_gather_bucket_tile(), lib.scatter_gather_bucket_hub())
    if got != (BUCKET_TILE, BUCKET_HUB):
        raise RuntimeError(f"scatter_gather: the library's bucket tile and "
                           f"hub are {got}, the wrapper's "
                           f"{(BUCKET_TILE, BUCKET_HUB)}")
    _typed = lib
    return lib


def scatter_gather_aggregate(src, dst, w, h, block_cols=None, n_out=None,
                             caller=None):
    """src/dst [C,E] int32 (padding edges carry w == 0 and any index in
    range); w [C,E] float32; h [C,N,F] float32 or bfloat16. Returns
    [C,n_out,F] in h's dtype (``n_out`` in [0, N]; None = N): the sums
    of the destinations in [0, n_out), edges to the others dropped.
    ``block_cols`` (128, 64 or 32; None = ``sort_block_cols(N, E, F)``)
    sets the sort kernel's columns a block; a width the sort kernel cannot
    take at (N, E) raises. The sort kernel writes all N rows, of which the
    first n_out are returned; the bucket kernel writes n_out. A launch made
    for a named ``caller`` also counts in ``caller_launches[caller]``."""
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
    if n_out is None:
        n_out = N
    elif not 0 <= n_out <= N:
        raise ValueError(f"scatter_gather_aggregate: n_out={n_out} outside "
                         f"[0, N={N}]")
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError("scatter_gather_aggregate: src/dst must be int32")
    if w.dtype != torch.float32 or h.dtype not in _SUFFIX:
        raise TypeError(f"scatter_gather_aggregate: w must be float32 and h "
                        f"float32 or bfloat16, got {w.dtype} and {h.dtype}")
    if block_cols is not None and not sort_block_fits(N, E, block_cols):
        raise ValueError(f"scatter_gather_aggregate: block_cols="
                         f"{block_cols} is not a width the sort kernel takes "
                         f"at N={N}, E={E} (candidates "
                         f"{BLOCK_COLS_CANDIDATES}, shared memory and E <= "
                         f"{SORT_MAX_EDGES} permitting)")
    dev = h.device
    if src.device != dev or dst.device != dev or w.device != dev:
        raise ValueError("scatter_gather_aggregate: inputs on different "
                         "devices")
    if not h.is_cuda:
        if dev.type == "cpu":
            return scatter_gather_aggregate_ref(src, dst, w, h, n_out)
        raise ValueError(f"scatter_gather_aggregate: unsupported device "
                         f"{dev}")
    if torch.is_grad_enabled() and (w.requires_grad or h.requires_grad):
        build.refuse_grad("scatter_gather_aggregate", w, h)
    if not (src.is_contiguous() and dst.is_contiguous()
            and w.is_contiguous() and h.is_contiguous()):
        raise ValueError("scatter_gather_aggregate: inputs must be "
                         "contiguous")
    variant = sg_variant(N, E)
    lib = _lib()
    dt = _SUFFIX[h.dtype]
    ptrs = (src.data_ptr(), dst.data_ptr(), w.data_ptr(), h.data_ptr())
    idx = dev.index
    if variant == "sort":
        block_cols = block_cols or sort_block_cols(N, E, F)
        out = torch.empty((C, N, F), dtype=h.dtype, device=dev)
        launch = lambda s: getattr(lib, f"scatter_gather_sort_{dt}")(  # noqa
            *ptrs, out.data_ptr(), C, N, E, F, block_cols, s)
    else:
        out = torch.empty((C, n_out, F), dtype=h.dtype, device=dev)
        # sized from the shapes alone; freed on return: the caching
        # allocator may hand it out again at once, but only to work
        # queued behind these kernels on this stream
        scratch = torch.empty(
            lib.scatter_gather_bucket_scratch_words(C, N, n_out, E, F),
            dtype=torch.int32, device=dev)
        launch = lambda s: getattr(lib, f"scatter_gather_bucket_{dt}")(  # noqa
            *ptrs, out.data_ptr(), scratch.data_ptr(), C, N, n_out, E, F, s)
    if idx == torch.cuda.current_device():
        err = launch(torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = launch(torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"scatter_gather_aggregate: {variant} kernel "
                           f"launch failed (cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
        variant_launches[variant] += 1
        if variant == "sort":
            width_launches[block_cols] += 1
        if caller is not None:
            caller_launches[caller] = caller_launches.get(caller, 0) + 1
        key = (variant, C, N, E, F)
        shape_launches[key] = shape_launches.get(key, 0) + 1
    if op_analysis.active() is not None:
        c = sg_cost(src, dst, w, h, n_out)
        op_analysis.note_kernel("scatter_gather_aggregate", c["flops"],
                                c["hbm_bytes"], torch.float32)
    if variant == "sort" and n_out != N:
        return out[:, :n_out].contiguous()
    return out


def sg_cost(src, dst, w, h, n_out=None) -> dict:
    """The function's operations and bytes (chip_smoke.py's bound and the
    launch analysis share it): 2 F for each edge of weight != 0 (this
    batch's count: it reads w, so it waits for the card), each input read
    once and the output [C, n_out, F] (``n_out`` None: N) written once."""
    C, N, F = h.shape
    n = N if n_out is None else n_out
    moved = sum(t.numel() * t.element_size() for t in (src, dst, w, h)) \
        + h.element_size() * C * n * F
    return {"flops": 2.0 * int((w != 0).sum()) * F, "hbm_bytes": moved}
