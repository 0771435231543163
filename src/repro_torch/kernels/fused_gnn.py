"""Fused GNN layer: the CUDA kernel ``csrc/fused_gnn.cu`` and its plain
PyTorch version.

    out[c] = act(A[c] @ (H[c] @ W_neigh) + H[c] @ W_self + b) * mask[c]

Replaces the TPU kernel ``fused_gnn_layer`` (src/repro/kernels/fused_gnn.py,
``_kernel``). Two kernels, chosen by ``fused_variant`` from the shapes before
launch:

- ``"tf32x3"`` (N <= 256, Fin a multiple of 4 and, with W_neigh, N too;
  16-byte aligned h and adj: every shape of the serving path): the tensor
  cores (``wgmma`` tf32) at about fp32 accuracy by the 3xTF32 split
  x = hi + lo, a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; one launch a call,
  HW kept in shared memory as the TPU kernel keeps it in VMEM. Bound on an
  H100 at the serving shape: tensor-core operations (3 x 6.44 GFLOP over
  494.7 TFLOP/s dense TF32).
- ``"cuda_core"`` (the rest, and every bfloat16 call: the tf32x3 kernel's
  TMA boxes and split are laid out for fp32): fp32 on the CUDA cores, a
  register-blocked shared-memory GEMM in two passes (H @ W_neigh into an
  fp32 scratch buffer, then A @ HW + H @ W_self with bias, activation and
  row mask in the epilogue).

h, the weights, the bias and the output are float32, or all bfloat16 as
the reference takes them (adj and mask stay float32; products and sums in
fp32, the output rounded once).

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the chosen kernel or raises (it never switches to the
other kernel after a failure). ``launches`` counts launches (one a call,
whatever the passes), ``variant_launches`` each kernel's.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

ACTS = {"none": lambda x: x, "relu": torch.relu,
        "elu": torch.nn.functional.elu}
ACT_CODES = {"none": 0, "relu": 1, "elu": 2}

# both kernels' output tiles are 64 columns wide; block_f (the reference's
# output-feature block) is rounded up to whole tiles and groups column
# tiles per thread block of the cuda_core kernel (the tf32x3 kernel takes
# one tile a block), so it never changes a result
TILE_N = 64
VARIANTS = ("tf32x3", "cuda_core")
TF32X3_MAX_N = 256          # the tf32x3 kernel keeps all N rows in a block
# shared memory of one block (bytes): tf32x3's fixed layout (two ring-1
# stages of an H box and four W k-tiles, two A boxes, 10 mbarriers, 1,024
# of alignment; the library's fused_tf32x3_smem_bytes must agree), and
# cuda_core's two stages of a 16 x 64 X tile and Y tile
SMEM_BYTES = {"tf32x3": 197_712, "cuda_core": 16_384}

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def fused_variant(N: int, Fin: int, neigh: bool, aligned: bool = True,
                  bf16: bool = False) -> str:
    """The kernel that takes h [C,N,Fin] (and adj [C,N,N] when ``neigh``);
    ``aligned``: h and adj start on 16-byte boundaries. The tf32x3 kernel
    reads them with TMA, whose row strides must be multiples of 16 bytes;
    it takes fp32 only (``bf16`` goes to cuda_core)."""
    if (not bf16 and aligned and N <= TF32X3_MAX_N and Fin % 4 == 0
            and (not neigh or N % 4 == 0)):
        return "tf32x3"
    return "cuda_core"


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
    for fn in (lib.fused_gnn_layer_f32, lib.fused_gnn_layer_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    lib.fused_gnn_layer_tf32x3.argtypes = [p, p, p, p, p, p, p,
                                           i, i, i, i, i, p]
    lib.fused_gnn_layer_tf32x3.restype = i
    lib.fused_tf32x3_smem_bytes.restype = i
    if lib.fused_tf32x3_smem_bytes() != SMEM_BYTES["tf32x3"]:
        raise RuntimeError(f"fused_gnn_layer: the library's tf32x3 block "
                           f"takes {lib.fused_tf32x3_smem_bytes()} bytes of "
                           f"shared memory, the wrapper's table "
                           f"{SMEM_BYTES['tf32x3']}")
    return lib


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"fused_gnn_layer: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_gnn_layer: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fused_gnn_layer: {name} is on {t.device}, h on "
                         f"{device}")


def fused_gnn_layer(adj, h, w_neigh, w_self=None, b=None, mask=None, *,
                    act: str = "relu", block_f: int = TILE_N):
    """adj [C,N,N] (may be None when w_neigh is None); h [C,N,Fin];
    w_neigh / w_self [Fin,Fout] (either may be None, not both); b [Fout];
    mask [C,N]. h, the weights and b float32 or all bfloat16; adj and mask
    float32. Returns [C,N,Fout] in h's dtype."""
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
    dev, dt = h.device, h.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_gnn_layer: h must be float32 or bfloat16, "
                        f"got {dt}")
    _check("h", h, (C, N, Fin), dev, dt)
    for name, t, shape, tdt in (("w_neigh", w_neigh, (Fin, Fout), dt),
                                ("w_self", w_self, (Fin, Fout), dt),
                                ("b", b, (Fout,), dt),
                                ("mask", mask, (C, N), torch.float32)):
        if t is not None:
            _check(name, t, shape, dev, tdt)
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
    neigh = w_neigh is not None
    aligned = h.data_ptr() % 16 == 0 and (not neigh
                                          or adj.data_ptr() % 16 == 0)
    bf16 = dt == torch.bfloat16
    variant = fused_variant(N, Fin, neigh, aligned, bf16)
    lib = _lib()
    out = torch.empty((C, N, Fout), dtype=dt, device=dev)
    if variant == "tf32x3":
        ptr = [t.data_ptr() if t is not None else None for t in (*args, out)]
        launch = lambda s: lib.fused_gnn_layer_tf32x3(  # noqa: E731
            *ptr, C, N, Fin, Fout, ACT_CODES[act], s)
    else:
        hw = torch.empty((C, N, Fout), dtype=torch.float32, device=dev) \
            if neigh else None
        col_block = -(-bf // TILE_N) * TILE_N
        ptr = [t.data_ptr() if t is not None else None
               for t in (*args, hw, out)]
        fn = lib.fused_gnn_layer_bf16 if bf16 else lib.fused_gnn_layer_f32
        launch = lambda s: fn(  # noqa: E731
            *ptr, C, N, Fin, Fout, col_block, ACT_CODES[act], s)
    with torch.cuda.device(dev):
        err = launch(torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_gnn_layer: {variant} kernel launch failed "
                           f"(error {err})")
    global launches
    with _count_lock:
        launches += 1
        variant_launches[variant] += 1
    return out
