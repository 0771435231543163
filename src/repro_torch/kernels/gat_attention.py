"""Dense GAT attention: the CUDA kernel ``csrc/gat_attention.cu`` and its
plain PyTorch version.

Per subgraph c and head hh: e = LeakyReLU(s_dst_i + s_src_j), masked to
-1e30 where ``struct <= 0``; a row softmax whose exp is masked again after
the max and whose denominator is clamped at 1e-20 (rows with no structure
give 0); then ``attn @ z_head``.

Replaces the TPU kernel ``gat_attention`` (src/repro/kernels/
gat_attention.py, ``_kernel``), which holds a head's whole [N, N] score
matrix on chip. Bound on an H100: fp32 operations where the structure is
dense, bytes where it is sparse. The kernel gives one warp each destination
row: its N scores sit in shared memory, max and sum are warp reductions,
and the weighted sum skips entries outside the structure.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

launches = 0
_count_lock = threading.Lock()


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
    lib.gat_attention_f32.argtypes = [p, p, p, p, p, i, i, i, i,
                                      ctypes.c_float, p]
    lib.gat_attention_f32.restype = i
    lib.gat_attention_smem_bytes.argtypes = [i]
    lib.gat_attention_smem_bytes.restype = i
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
    lib = _lib()
    if lib.gat_attention_smem_bytes(N) > build.MAX_SMEM:
        raise ValueError(f"gat_attention: N={N} needs more shared memory "
                         f"than a block has")
    out = torch.empty((C, N, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gat_attention_f32(
            z.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            struct.data_ptr(), out.data_ptr(), C, N, F, n_heads,
            float(negative_slope), stream)
    if err:
        raise RuntimeError(f"gat_attention: CUDA launch failed "
                           f"(cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
    return out
