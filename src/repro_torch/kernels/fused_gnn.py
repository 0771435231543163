"""Fused GNN layer: the CUDA kernel ``csrc/fused_gnn.cu`` and its plain
PyTorch version.

    out[c] = act(A[c] @ (H[c] @ W_neigh) + H[c] @ W_self + b) * mask[c]

Replaces the TPU kernel ``fused_gnn_layer`` (src/repro/kernels/fused_gnn.py,
``_kernel``). Three kernels, chosen by ``fused_variant`` from the dtype and
shapes before launch:

- ``"tf32x3"`` (N <= 256, Fin a multiple of 4 and, with W_neigh, N too;
  16-byte aligned h and adj: every shape of the serving path): the tensor
  cores (``wgmma`` tf32) at about fp32 accuracy by the 3xTF32 split
  x = hi + lo, a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; one launch a call,
  HW kept in shared memory as the TPU kernel keeps it in VMEM. Bound on an
  H100 at the serving shape: tensor-core operations (3 x 6.44 GFLOP over
  494.7 TFLOP/s dense TF32). It takes each weight split (``weight_split``:
  W^T's tf32 hi and lo, made once a weight and kept while the weight is
  unchanged), so no thread block splits the weights again.
- ``"wgmma_bf16"`` (bfloat16 at the same shapes, with Fin and Fout
  multiples of 8 and 16-byte aligned weights): the tf32x3 kernel's
  pipeline with H.W_neigh and H.W_self as bf16 ``wgmma`` products (exact in
  fp32) straight from the TMA-loaded bf16 tiles, W read MN-major with the
  transpose bit, each 64-wide k-tile summed into a fresh fp32 partial; HW
  stays fp32 and A @ HW runs in three tf32 products as in tf32x3; one
  rounding to bf16 at the end.
- ``"cuda_core"`` (the rest): fp32 on the CUDA cores, a register-blocked
  shared-memory GEMM in two passes (H @ W_neigh into an fp32 scratch
  buffer, then A @ HW + H @ W_self with bias, activation and row mask in
  the epilogue).

h, the weights, the bias and the output are float32, or all bfloat16 as
the reference takes them (adj and mask stay float32; products and sums in
fp32, the output rounded once).

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the chosen kernel or raises (it never switches to the
other kernel after a failure). ``launches`` counts launches (one a call,
whatever the passes), ``variant_launches`` each kernel's,
``form_launches`` them by (kernel, Fin, form).
"""
from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_analysis

ACTS = {"none": lambda x: x, "relu": torch.relu,
        "elu": torch.nn.functional.elu}
ACT_CODES = {"none": 0, "relu": 1, "elu": 2}

# both kernels' output tiles are 64 columns wide; block_f (the reference's
# output-feature block) is rounded up to whole tiles and groups column
# tiles per thread block of the cuda_core kernel (the tf32x3 kernel takes
# one tile a block), so it never changes a result
TILE_N = 64
# block_f values that autotune sweeps (the reference's BLOCK_F_CANDIDATES);
# only the cuda_core kernel groups tiles by it
BLOCK_F_CANDIDATES = (64, 128, 256, 512)
VARIANTS = ("tf32x3", "wgmma_bf16", "cuda_core")
TF32X3_MAX_N = 256          # the tensor-core kernels keep all N rows a block
# shared memory of one block (bytes): tf32x3's largest layout (three ring-1
# stages of an H box and four W^T k-tiles, the last under two A boxes, 10
# mbarriers, 1,024 of alignment; the library's fused_tf32x3_smem_bytes
# must agree),
# wgmma_bf16's (three ring-1 stages of a bf16 H box and two W k-tiles, two
# A boxes, 10 mbarriers, 1,024; fused_bf16_smem_bytes), and cuda_core's two
# stages of a 16 x 64 X tile and Y tile
SMEM_BYTES = {"tf32x3": 197_712, "wgmma_bf16": 214_096, "cuda_core": 16_384}

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
# launches by (variant, Fin, form): "w_neigh", "+w_self" or "self-only"
form_launches: dict = {}
_count_lock = threading.Lock()

# the tf32x3 kernel's split weights: (id of the weight's base tensor, data
# pointer, shape, strides) -> (weak reference to that base, the weight's
# _version when split, the split, the raw stream it was made on)
_splits: dict = {}
_splits_lock = threading.RLock()
splits_made = 0     # splits weight_split has made (kept or not)


def fused_variant(N: int, Fin: int, neigh: bool, aligned: bool = True,
                  bf16: bool = False, Fout: int | None = None) -> str:
    """The kernel that takes h [C,N,Fin] (and adj [C,N,N] when ``neigh``)
    and weights [Fin, Fout]; ``aligned``: h, adj and (bf16) the weights
    start on 16-byte boundaries. The tensor-core kernels read them with
    TMA, whose row strides must be multiples of 16 bytes: fp32 h needs Fin
    % 4 == 0 (tf32x3), bf16 h and weights Fin and Fout % 8 == 0
    (wgmma_bf16), fp32 adj N % 4 == 0. bf16 needs ``Fout``."""
    if bf16 and Fout is None:
        raise ValueError("fused_variant: bf16 weights' rows need Fout")
    if (not aligned or N > TF32X3_MAX_N or (neigh and N % 4)
            or Fin % (8 if bf16 else 4) or (bf16 and Fout % 8)):
        return "cuda_core"
    return "wgmma_bf16" if bf16 else "tf32x3"


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


def tf32_rna(x):
    """fp32 ``x`` rounded to the nearest tf32 (10 mantissa bits, ties away
    from zero) with the 13 low bits cleared: bit for bit what the kernels'
    ``tf32_rna`` (``cvt.rna.tf32.f32``, then ``& 0xFFFFE000``) gives, for
    every value but NaN, which stays NaN."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def tf32_split(w):
    """The tf32x3 kernel's operand for a weight ``w`` [Fin, Fout]: W^T's
    tf32 hi and lo, [2, Fout, Fin] (K-major, as tf32 wgmma reads B):
    hi = tf32(W^T), lo = tf32(W^T - hi) (the difference is exact in
    fp32)."""
    wt = w.t().contiguous()
    hi = tf32_rna(wt)
    return torch.stack((hi, tf32_rna(wt - hi)))


def _drop_split(key, _ref):
    with _splits_lock:
        _splits.pop(key, None)


def weight_split(w, stream=None):
    """``tf32_split(w)``, made once a weight and kept while the weight is
    unchanged: a later call with the same weight, or with a new view of the
    same elements (the engine's inner layers index one stacked tensor
    afresh every call), takes the kept split and launches nothing. The key
    holds the weight's base tensor by a weak reference (an entry leaves
    when its tensor is freed, and a new tensor at a freed tensor's address
    is another object: it never matches) and its ``_version`` (an in-place
    update, through any view, makes a new split). Inference tensors keep
    no version: they are split on every call. A new split waits for its
    stream once, so that any stream may read it; read on another stream,
    it is recorded there, so that freeing it waits for that stream's work.
    Under CUDA graph capture a kept split is read as it is (the graph reads
    it on every replay: update the weight in place, and capture again),
    and a missing one is made inside the graph and not kept. ``stream``:
    the raw current stream of the weight's device, where the caller has
    it."""
    global splits_made
    if w.is_inference():
        splits_made += 1
        return tf32_split(w)
    cuda = w.is_cuda
    if cuda and stream is None:
        stream = torch._C._cuda_getCurrentRawStream(w.device.index)
    base = w if w._base is None else w._base
    key = (id(base), w.data_ptr(), w.shape, w.stride())
    version = w._version
    entry = _splits.get(key)
    if entry is not None and entry[0]() is base and entry[1] == version:
        if entry[3] != stream and not torch.cuda.is_current_stream_capturing():
            entry[2].record_stream(torch.cuda.current_stream(w.device))
        return entry[2]
    capturing = cuda and torch.cuda.is_current_stream_capturing()
    split = tf32_split(w)
    splits_made += 1
    if capturing:
        return split
    if cuda:
        torch.cuda.current_stream(w.device).synchronize()
    with _splits_lock:
        _splits[key] = (weakref.ref(base, functools.partial(_drop_split,
                                                            key)),
                        version, split, stream)
    return split


_typed = None       # the library whose argument types are set


def _lib():
    """The kernels' library, its functions' argument types set and its
    shared-memory table checked once a library."""
    global _typed
    lib = build.load("fused_gnn")
    if lib is _typed:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fused_gnn_layer_f32, lib.fused_gnn_layer_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.fused_gnn_layer_tf32x3, lib.fused_gnn_layer_wgmma_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    for variant, fn in (("tf32x3", lib.fused_tf32x3_smem_bytes),
                        ("wgmma_bf16", lib.fused_bf16_smem_bytes)):
        fn.restype = i
        if fn() != SMEM_BYTES[variant]:
            raise RuntimeError(f"fused_gnn_layer: the library's {variant} "
                               f"block takes {fn()} bytes of shared memory, "
                               f"the wrapper's table {SMEM_BYTES[variant]}")
    _typed = lib
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
    build.refuse_grad("fused_gnn_layer", adj, h, w_neigh, w_self, b, mask)
    args = [adj if w_neigh is not None else None, h, w_neigh, w_self, b,
            mask]
    for t in args:
        if t is not None and not t.is_contiguous():
            raise ValueError("fused_gnn_layer: inputs must be contiguous")
    neigh = w_neigh is not None
    bf16 = dt == torch.bfloat16
    aligned = all(t.data_ptr() % 16 == 0 for t in (
        h, adj if neigh else None, *((w_neigh, w_self) if bf16 else ()))
        if t is not None)
    variant = fused_variant(N, Fin, neigh, aligned, bf16, Fout)
    lib = _lib()
    idx = dev.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    out = torch.empty((C, N, Fout), dtype=dt, device=dev)
    if variant != "cuda_core":
        fn = lib.fused_gnn_layer_wgmma_bf16 if bf16 \
            else lib.fused_gnn_layer_tf32x3
        if not bf16:        # the tf32x3 kernel reads the weights split
            args[2:4] = [None if w is None else weight_split(w, stream)
                         for w in args[2:4]]
        ptr = [t.data_ptr() if t is not None else None for t in (*args, out)]
        launch = lambda s: fn(  # noqa: E731
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
    if idx == torch.cuda.current_device():
        err = launch(stream)
    else:
        with torch.cuda.device(idx):
            err = launch(stream)
    if err:
        raise RuntimeError(f"fused_gnn_layer: {variant} kernel launch failed "
                           f"(error {err})")
    global launches
    form = ("+w_self" if w_self is not None else "w_neigh") if neigh \
        else "self-only"
    with _count_lock:
        launches += 1
        variant_launches[variant] += 1
        key = (variant, Fin, form)
        form_launches[key] = form_launches.get(key, 0) + 1
    if op_analysis.active() is not None:
        c = fused_cost(adj, h, w_neigh, w_self, b, mask)
        if variant == "wgmma_bf16":
            # H.W's products in bf16, A.HW's in three tf32 products
            agg = 2.0 * C * N * N * Fout if neigh else 0.0
            flops = {torch.bfloat16: c["flops"] - agg, "tf32x3": agg}
        else:
            flops = {"tf32x3" if variant == "tf32x3" else torch.float32:
                     c["flops"]}
        op_analysis.note_kernel("fused_gnn_layer", flops, c["hbm_bytes"])
    return out


def fused_cost(adj, h, w_neigh, w_self=None, b=None, mask=None) -> dict:
    """The function's operations and bytes (chip_smoke.py's bound and the
    launch analysis share it): 2 C N Fin Fout a weight matrix, plus 2 C N N
    Fout for A.(H.W); each input read once (adj only with w_neigh) and the
    output [C, N, Fout] written once. The tf32x3 kernel issues three tf32
    products a multiply-add: the roofline prices its operations at a third
    of the tf32 rate."""
    C, N, fin = h.shape
    w = w_neigh if w_neigh is not None else w_self
    fout = w.shape[1]
    flops = 2.0 * C * N * fin * fout * ((w_neigh is not None)
                                        + (w_self is not None))
    if w_neigh is not None:
        flops += 2.0 * C * N * N * fout
    moved = sum(t.numel() * t.element_size() for t in (
        adj if w_neigh is not None else None, h, w_neigh, w_self, b, mask)
        if t is not None) + h.element_size() * C * N * fout
    return {"flops": flops, "hbm_bytes": moved}
