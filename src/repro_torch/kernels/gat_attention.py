"""Dense GAT attention: the CUDA kernels ``csrc/gat_attention.cu`` and their
plain PyTorch version.

Per subgraph c and head hh: e = LeakyReLU(s_dst_i + s_src_j), masked to
-1e30 where ``struct <= 0``; a row softmax whose exp is masked again after
the max and whose denominator is clamped at 1e-20 (rows with no structure
give 0); then ``attn @ z_head`` over all N rows, so a weight of 0 times an
inf or NaN in z gives NaN, as the oracle (``repro.kernels.ref.
gat_attention_ref``) does.

Replaces the TPU kernel ``gat_attention`` (src/repro/kernels/
gat_attention.py, ``_kernel``), which holds a head's whole [N, N] score
matrix on chip. Bound on an H100: bytes (z and struct read once, out
written once). Two kernels, chosen by ``gat_variant`` from the shapes
before launch:

- ``"slab"`` (N <= 256, N and the head width multiples of 4, 16-byte
  aligned z and struct: every serving shape): one block per (subgraph, up
  to 64 columns of one head) stages its z slab in shared memory, packs the
  structure into a bitmap in one pass, and gives each destination row to a
  warp that compacts the row's structural columns into a list, takes the
  softmax over the list and sums the listed z rows from shared memory;
  non-finite z rows outside a row's structure make NaN in their columns.
- ``"row"`` (the rest): one warp per destination row over all N columns,
  z read from L2.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the chosen kernel or raises (it never switches to the
other kernel after a failure). ``launches`` counts launches,
``variant_launches`` each kernel's.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
VARIANTS = ("slab", "row")
SLAB_MAX_N = 256            # two 16-byte structure loads a lane a row;
                            # the library's gat_slab_max_n() must agree

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def gat_variant(N: int, F: int, n_heads: int, *, aligned: bool) -> str:
    """The kernel that takes z [C,N,F] with ``n_heads`` heads (F divisible
    by n_heads); ``aligned``: z and struct start on 16-byte boundaries. The
    slab kernel copies z and reads struct 16 bytes at a time, so its rows
    and head slices must be whole 16-byte units."""
    if aligned and N <= SLAB_MAX_N and N % 4 == 0 \
            and (F // n_heads) % 4 == 0:
        return "slab"
    return "row"


def gat_attention_ref(z, s_src, s_dst, struct, *, n_heads,
                      negative_slope=0.2, **_):
    """Plain PyTorch version (``repro.kernels.ref.gat_attention_ref``)."""
    C, N, F = z.shape
    fh = F // n_heads
    zf = z.float().reshape(C, N, n_heads, fh)
    e = (s_dst.float().permute(0, 2, 1)[:, :, :, None]
         + s_src.float().permute(0, 2, 1)[:, :, None, :])
    e = torch.where(e >= 0, e, negative_slope * e)
    emask = (struct > 0)[:, None, :, :]
    e = torch.where(emask, e, torch.full_like(e, NEG_INF))
    attn = torch.softmax(e, dim=-1)
    attn = torch.where(emask, attn, torch.zeros_like(attn))
    out = torch.einsum("chij,cjhf->cihf", attn, zf)
    return out.reshape(C, N, F).to(z.dtype)


def _lib():
    lib = build.load("gat_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gat_attention_slab_f32, lib.gat_attention_row_f32):
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    for fn in (lib.gat_slab_smem_bytes, lib.gat_row_smem_bytes):
        fn.argtypes = [i]
        fn.restype = i
    lib.gat_slab_max_n.restype = i
    if lib.gat_slab_max_n() != SLAB_MAX_N:
        raise RuntimeError(f"gat_attention: the library's slab kernel takes "
                           f"N <= {lib.gat_slab_max_n()}, the wrapper routes "
                           f"N <= {SLAB_MAX_N} to it")
    return lib


def gat_attention(z, s_src, s_dst, struct, *, n_heads: int,
                  negative_slope: float = 0.2):
    """z [C,N,F]; s_src/s_dst [C,N,heads]; struct [C,N,N] (> 0 where edge
    j -> i or i == j). All float32. Returns [C,N,F]."""
    if z.dim() != 3:
        raise ValueError(f"gat_attention: z must be [C,N,F], got "
                         f"{tuple(z.shape)}")
    C, N, F = z.shape
    if n_heads < 1 or F % n_heads:
        raise ValueError(f"gat_attention: F={F} not divisible by "
                         f"n_heads={n_heads}")
    for name, t, shape in (("s_src", s_src, (C, N, n_heads)),
                           ("s_dst", s_dst, (C, N, n_heads)),
                           ("struct", struct, (C, N, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gat_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    tensors = (z, s_src, s_dst, struct)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("gat_attention: inputs must be float32")
    dev = z.device
    if any(t.device != dev for t in tensors):
        raise ValueError("gat_attention: inputs on different devices")
    if dev.type == "cpu":
        return gat_attention_ref(z, s_src, s_dst, struct, n_heads=n_heads,
                                 negative_slope=negative_slope)
    if dev.type != "cuda":
        raise ValueError(f"gat_attention: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gat_attention: inputs must be contiguous")
    variant = gat_variant(N, F, n_heads, aligned=z.data_ptr() % 16 == 0
                          and struct.data_ptr() % 16 == 0)
    lib = _lib()
    smem = (lib.gat_slab_smem_bytes if variant == "slab"
            else lib.gat_row_smem_bytes)(N)
    if smem > build.MAX_SMEM:
        raise ValueError(f"gat_attention: N={N} needs more shared memory "
                         f"than a block has")
    launch = (lib.gat_attention_slab_f32 if variant == "slab"
              else lib.gat_attention_row_f32)
    out = torch.empty((C, N, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(z.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
                     struct.data_ptr(), out.data_ptr(), C, N, F, n_heads,
                     float(negative_slope), stream)
    if err:
        raise RuntimeError(f"gat_attention: {variant} kernel launch failed "
                           f"(cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
        variant_launches[variant] += 1
    return out
