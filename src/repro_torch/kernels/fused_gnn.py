"""Fused GNN layer: the CUDA kernel ``csrc/fused_gnn.cu`` and its plain
PyTorch version.

    out[c] = act(A[c] @ (H[c] @ W_neigh) + H[c] @ W_self + b) * mask[c]

Replaces the TPU kernel ``fused_gnn_layer`` (src/repro/kernels/fused_gnn.py,
``_kernel``). Bound on an H100: fp32 operations at the serving shapes (N=256,
Fin=512, Fout=256 do ~64 FLOP a byte, above the CUDA cores' ridge of 20);
the kernel is a register-blocked, double-buffered shared-memory GEMM on the
CUDA cores, in two passes (H @ W_neigh into a scratch buffer, then
A @ HW + H @ W_self with bias, activation and row mask in the epilogue). TF32 is not used: the fp32
tolerance is 2e-5. Keeping HW on chip, as the TPU kernel does, is later work.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launches`` counts kernel
launches (one a call, whatever the passes).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

ACTS = {"none": lambda x: x, "relu": torch.relu,
        "elu": torch.nn.functional.elu}
ACT_CODES = {"none": 0, "relu": 1, "elu": 2}

# the kernel's output tile is 64 columns wide; block_f (the reference's
# output-feature block) is rounded up to whole tiles and groups column
# tiles per thread block, so it never changes a result. The default of one
# tile per block gives the most blocks (1,024 at C=64, N=256, Fout=256)
_TILE_N = 64

launches = 0
_count_lock = threading.Lock()


def fused_gnn_layer_ref(adj, h, w_neigh, w_self=None, b=None, mask=None, *,
                        act="relu", **_):
    """Plain PyTorch version (``repro.kernels.ref.fused_gnn_layer_ref``)."""
    C, N, Fin = h.shape
    w_any = w_neigh if w_neigh is not None else w_self
    acc = torch.zeros((C, N, w_any.shape[1]), dtype=torch.float32,
                      device=h.device)
    if w_neigh is not None:
        z = torch.einsum("cij,cjf->cif", adj.float(), h.float())
        acc = acc + torch.einsum("cnf,fg->cng", z, w_neigh.float())
    if w_self is not None:
        acc = acc + torch.einsum("cnf,fg->cng", h.float(), w_self.float())
    if b is not None:
        acc = acc + b.float()
    out = ACTS[act](acc)
    if mask is not None:
        out = out * mask[..., None].float()
    return out.to(h.dtype)


def _lib():
    lib = build.load("fused_gnn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_gnn_layer_f32.argtypes = [p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, p]
    lib.fused_gnn_layer_f32.restype = i
    return lib


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"fused_gnn_layer: {name} must be float32, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_gnn_layer: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fused_gnn_layer: {name} is on {t.device}, h on "
                         f"{device}")


def fused_gnn_layer(adj, h, w_neigh, w_self=None, b=None, mask=None, *,
                    act: str = "relu", block_f: int = _TILE_N):
    """adj [C,N,N] (may be None when w_neigh is None); h [C,N,Fin];
    w_neigh / w_self [Fin,Fout] (either may be None, not both); b [Fout];
    mask [C,N]. Returns [C,N,Fout] float32."""
    if h.dim() != 3:
        raise ValueError(f"fused_gnn_layer: h must be [C,N,Fin], got "
                         f"{tuple(h.shape)}")
    C, N, Fin = h.shape
    w_any = w_neigh if w_neigh is not None else w_self
    if w_any is None:
        raise ValueError("fused_gnn_layer: w_neigh and w_self are both None")
    if act not in ACT_CODES:
        raise ValueError(f"fused_gnn_layer: unknown act {act!r}")
    Fout = w_any.shape[-1]
    bf = min(block_f, Fout)
    if bf < 1 or Fout % bf:
        raise ValueError(f"fused_gnn_layer: block_f={block_f} does not "
                         f"divide Fout={Fout}")
    dev = h.device
    _check("h", h, (C, N, Fin), dev)
    for name, t, shape in (("w_neigh", w_neigh, (Fin, Fout)),
                           ("w_self", w_self, (Fin, Fout)),
                           ("b", b, (Fout,)), ("mask", mask, (C, N))):
        if t is not None:
            _check(name, t, shape, dev)
    if w_neigh is not None:
        if adj is None:
            raise ValueError("fused_gnn_layer: adj is required with w_neigh")
        _check("adj", adj, (C, N, N), dev)
    if dev.type == "cpu":
        return fused_gnn_layer_ref(adj, h, w_neigh, w_self, b, mask,
                                   act=act)
    if dev.type != "cuda":
        raise ValueError(f"fused_gnn_layer: unsupported device {dev}")
    args = [adj if w_neigh is not None else None, h, w_neigh, w_self, b,
            mask]
    for t in args:
        if t is not None and not t.is_contiguous():
            raise ValueError("fused_gnn_layer: inputs must be contiguous")
    out = torch.empty((C, N, Fout), dtype=torch.float32, device=dev)
    hw = torch.empty((C, N, Fout), dtype=torch.float32, device=dev) \
        if w_neigh is not None else None
    col_block = -(-bf // _TILE_N) * _TILE_N
    ptr = [t.data_ptr() if t is not None else None
           for t in (*args, hw, out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fused_gnn_layer_f32(*ptr, C, N, Fin, Fout, col_block,
                                         ACT_CODES[act], stream)
    if err:
        raise RuntimeError(f"fused_gnn_layer: CUDA launch failed "
                           f"(cudaError {err})")
    global launches
    with _count_lock:
        launches += 1
    return out
