"""Flash attention (forward): the CUDA kernel ``csrc/flash_attention.cu``
and its plain PyTorch version.

Per (batch, head): scores ``q . k^T * (1/sqrt(D))`` in fp32; when causal,
``row >= col`` (top-left aligned, counted from 0) or -1e30; softmax with
the denominator clamped at 1e-20; ``@ v`` in fp32; the result in q's type.

Replaces the TPU kernel ``flash_attention`` (src/repro/kernels/
flash_attention.py, ``_kernel``), which walks key blocks in a sequential
grid dimension with the online-softmax statistics in VMEM scratch. Bound
on an H100: operations (causal S=8192, D=128 does ~2,050 operations a
byte). The kernel takes one block per (batch*head, 64 query rows) and
loops over 64-row key tiles staged through shared memory, with the
running max, sum and accumulator in registers; tiles wholly above the
diagonal are skipped and ragged tiles masked, so, unlike the TPU
wrapper, any sequence length works.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launches`` counts launches.
``flash_cost`` is the reference's analytic cost model, kept beside it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain PyTorch version with the kernel's arithmetic, fp32
    throughout: unnormalized exp(s - max), then ``(p @ v) / max(l,
    1e-20)``, cast to q's type."""
    D = q.shape[-1]
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s.mul_(1.0 / D ** 0.5)
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, NEG_INF)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    den = p.sum(dim=-1, keepdim=True).clamp_min_(1e-20)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).div_(den)
    return out.to(q.dtype)


def _lib():
    lib = build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i,
                                        ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i]
    lib.flash_attention_smem_bytes.restype = i
    return lib


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B,H,Sq,D]; k/v [B,H,Sk,D] (GQA broadcast by the caller), all
    float32 or all bfloat16. Returns [B,H,Sq,D] in q's type."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B,H,S,D]")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(k.shape) != (B, H, Sk, D) or tuple(v.shape) != (B, H, Sk, D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match (k and v must be [B,H,Sk,D])")
    if Sq == 0 or Sk == 0 or D == 0:
        raise ValueError("flash_attention: empty sequence or head dim")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: inputs on different devices")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H={B * H} exceeds the grid's "
                         f"65535 blocks in y")
    lib = _lib()
    if lib.flash_attention_smem_bytes(D) > build.MAX_SMEM:
        raise ValueError(f"flash_attention: D={D} needs "
                         f"{lib.flash_attention_smem_bytes(D)} bytes of "
                         f"shared memory, more than a block has "
                         f"({build.MAX_SMEM})")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, Sq, Sk, D, 1.0 / D ** 0.5, int(bool(causal)),
            DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA launch failed "
                           f"(cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
    return out


def flash_cost(B, H, Sq, Sk, D, causal=True, bytes_per=2):
    """Analytic roofline terms of the function (the reference's
    ``flash_cost``): operations, halved when causal and square, and the
    bytes of q, k, v and the output each moved once."""
    frac = 0.5 if causal and Sq == Sk else 1.0
    flops = 4.0 * B * H * Sq * Sk * D * frac
    hbm = bytes_per * B * H * (Sq * D * 2 + Sk * D * 2)
    return {"flops": flops, "hbm_bytes": hbm}
