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
- ``"row"`` (the rest, and every bfloat16 call: the slab's staging and
  list walk are laid out for fp32): one warp per destination row over all
  N columns, z read from L2.

z and the output are float32 or bfloat16 (as the reference takes them: z
widened on load, every sum in fp32, the output rounded once); s_src, s_dst
and struct are float32.

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

_SLAB_COLS, _SLAB_WARPS, _PAD, _ROW_WARPS = 64, 16, 8, 8

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def slab_smem_bytes(N: int) -> int:
    """Shared memory of one slab-kernel block (``SlabLayout`` in the .cu;
    the library's gat_slab_smem_bytes must agree): the z slab and a zero
    row, the structure's bitmap, the scores, the non-finite masks, a flag
    and a list of N + 8 entries a warp."""
    nw = (N + 31) // 32
    bits = 4 * (N + 1) * _SLAB_COLS
    bad = bits + 4 * N * nw + 2 * 4 * 32 * nw
    lst = bad + 8 * N + 16
    return lst + 8 * _SLAB_WARPS * (N + _PAD)


def row_smem_bytes(N: int) -> int:
    """Shared memory of one row-kernel block: s_src and one score row a
    warp."""
    return (1 + _ROW_WARPS) * N * 4


def gat_variant(N: int, F: int, n_heads: int, *, aligned: bool,
                bf16: bool = False) -> str:
    """The kernel that takes z [C,N,F] with ``n_heads`` heads (F divisible
    by n_heads); ``aligned``: z and struct start on 16-byte boundaries. The
    slab kernel copies z and reads struct 16 bytes at a time, so its rows
    and head slices must be whole 16-byte units; it takes fp32 only
    (``bf16`` goes to the row kernel)."""
    if not bf16 and aligned and N <= SLAB_MAX_N and N % 4 == 0 \
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
    for fn in (lib.gat_attention_slab_f32, lib.gat_attention_row_f32,
               lib.gat_attention_row_bf16):
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
    for n in (200, 256, 320):
        if (lib.gat_slab_smem_bytes(n), lib.gat_row_smem_bytes(n)) != \
                (slab_smem_bytes(n), row_smem_bytes(n)):
            raise RuntimeError(f"gat_attention: the library's shared memory "
                               f"at N={n} disagrees with the wrapper's")
    return lib


def gat_attention(z, s_src, s_dst, struct, *, n_heads: int,
                  negative_slope: float = 0.2):
    """z [C,N,F]; s_src/s_dst [C,N,heads]; struct [C,N,N] (> 0 where edge
    j -> i or i == j). z float32 or bfloat16, the rest float32. Returns
    [C,N,F] in z's dtype."""
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
    if z.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError(f"gat_attention: z must be float32 or bfloat16 and "
                        f"s_src, s_dst, struct float32, got "
                        f"{[t.dtype for t in tensors]}")
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
    bf16 = z.dtype == torch.bfloat16
    variant = gat_variant(N, F, n_heads, aligned=z.data_ptr() % 16 == 0
                          and struct.data_ptr() % 16 == 0, bf16=bf16)
    lib = _lib()
    smem = (slab_smem_bytes if variant == "slab" else row_smem_bytes)(N)
    if smem > build.MAX_SMEM:
        raise ValueError(f"gat_attention: N={N} needs more shared memory "
                         f"than a block has")
    launch = (lib.gat_attention_slab_f32 if variant == "slab"
              else lib.gat_attention_row_bf16 if bf16
              else lib.gat_attention_row_f32)
    out = torch.empty((C, N, F), dtype=z.dtype, device=dev)
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
