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

``gat_attention_layer`` is GAT's whole attention step (``core/program.py``'s
AttentionScore + dense AttentionSoftmax) in one launch of the slab kernel's
fused form: from z, a_src and a_dst [heads, F/heads], adj [C,N,N] (the
batch's ``adj_mean``), mask [C,N], the bias and the activation, the kernel
takes each head's score terms from its staged slab, packs the structure
``(sign(adj) + I) * mask[:, None, :] > 0`` bit for bit as the plain path
builds it, and applies ``act(out + b) * mask[..., None]`` before its one
store. It saves the plain path's passes over [C,N,N] and [C,N,F] and its
two score GEMVs; it reads the same bytes as ``gat_attention`` (z, one
[C,N,N] matrix, out). ``layer_fits`` gives the shapes it takes (fp32, a head
of at most 64 columns in one slab, N <= 256, aligned), and ``launch_layer``
launches it for a caller that has checked them; on the CPU the wrapper
takes the plain composition ``gat_attention_layer_ref``. A fused
launch counts in ``launches`` and ``variant_launches["slab"]`` and in
``fused_launches``; ``fused_fallbacks`` counts the program's attention
steps that ran unfused on the card because the shapes did not fit.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_analysis

NEG_INF = -1e30
VARIANTS = ("slab", "row")
SLAB_MAX_N = 256            # two 16-byte structure loads a lane a row;
                            # the library's gat_slab_max_n() must agree

_SLAB_COLS, _SLAB_WARPS, _PAD, _ROW_WARPS = 64, 16, 8, 8

ACTS = ("none", "relu", "elu")          # the library's Act, in order

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
fused_launches = 0
fused_fallbacks = 0
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
    lib.gat_attention_layer_f32.argtypes = [p] * 7 + [i] * 4 + [
        ctypes.c_float, i, p]
    lib.gat_attention_layer_f32.restype = i
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
    build.refuse_grad("gat_attention", *tensors)
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
    if op_analysis.active() is not None:
        c = gat_cost(z, s_src, s_dst, struct, n_heads=n_heads)
        op_analysis.note_kernel("gat_attention", c["flops"],
                                c["hbm_bytes"], torch.float32)
    return out


def gat_cost(z, s_src, s_dst, struct, *, n_heads: int) -> dict:
    """The function's operations and bytes (chip_smoke.py's bound and the
    launch analysis share it): 6 C heads N N for the scores, LeakyReLU and
    softmax, and 2 F for each structural entry (struct > 0, this batch's
    count: it reads the structure, so it waits for the card) of attn.z;
    each input read once and the output [C, N, F] written once."""
    C, N, F = z.shape
    nnz = int((struct > 0).sum())
    moved = sum(t.numel() * t.element_size()
                for t in (z, s_src, s_dst, struct)) \
        + z.element_size() * C * N * F
    return {"flops": 2.0 * nnz * F + 6.0 * C * n_heads * N * N,
            "hbm_bytes": moved}


def layer_fits(z, a_src, a_dst, adj, mask, b, *, n_heads: int) -> bool:
    """Whether ``gat_attention_layer`` launches its fused kernel for these
    CUDA tensors: every input fp32 and contiguous, the slab kernel's shapes
    with one slab a head (N <= 256, N and the head width multiples of 4, the
    head width at most 64), and every input on a 16-byte boundary."""
    C, N, F = z.shape
    tensors = [t for t in (z, a_src, a_dst, adj, mask, b) if t is not None]
    return (all(t.dtype == torch.float32 and t.is_contiguous()
                and t.data_ptr() % 16 == 0 for t in tensors)
            and gat_variant(N, F, n_heads, aligned=True) == "slab"
            and F // n_heads <= _SLAB_COLS)


def gat_attention_layer_ref(z, a_src, a_dst, adj, mask, b=None, *,
                            n_heads, negative_slope=0.2, act="elu"):
    """The plain composition the fused launch replaces, op for op as
    ``core/program.py`` runs it under impl="cuda" on CPU tensors: the score
    terms as two einsums, the structure ``(sign(adj) + I) * mask[:, None,
    :]``, ``gat_attention_ref``, then ``act(out + b) * mask[..., None]``."""
    C, N, F = z.shape
    z4 = z.reshape(C, N, n_heads, F // n_heads)
    s_src = torch.einsum("cnhf,hf->cnh", z4, a_src)
    s_dst = torch.einsum("cnhf,hf->cnh", z4, a_dst)
    eye = torch.eye(N, dtype=z.dtype, device=z.device)
    struct = (torch.sign(adj) + eye) * mask[:, None, :]
    out = gat_attention_ref(z, s_src.contiguous(), s_dst.contiguous(),
                            struct, n_heads=n_heads,
                            negative_slope=negative_slope)
    out = out + b if b is not None else out
    if act == "relu":
        out = torch.relu(out)
    elif act == "elu":
        out = torch.nn.functional.elu(out)
    return out * mask[..., None]


def gat_attention_layer(z, a_src, a_dst, adj, mask, b=None, *,
                        n_heads: int, negative_slope: float = 0.2,
                        act: str = "elu"):
    """GAT's attention step in one launch. z [C,N,F]; a_src/a_dst [heads,
    F/heads]; adj [C,N,N] (the structure is (sign(adj) + I) * mask[j] > 0);
    mask [C,N]; b [F] or None; act "none", "relu" or "elu". Returns
    ``act(attention + b) * mask[..., None]`` [C,N,F]. CPU tensors take the
    plain composition; CUDA tensors launch the fused kernel where
    ``layer_fits`` holds and raise otherwise."""
    if z.dim() != 3:
        raise ValueError(f"gat_attention_layer: z must be [C,N,F], got "
                         f"{tuple(z.shape)}")
    C, N, F = z.shape
    if n_heads < 1 or F % n_heads:
        raise ValueError(f"gat_attention_layer: F={F} not divisible by "
                         f"n_heads={n_heads}")
    if act not in ACTS:
        raise ValueError(f"gat_attention_layer: act={act!r}, expected one "
                         f"of {ACTS}")
    shapes = [("a_src", a_src, (n_heads, F // n_heads)),
              ("a_dst", a_dst, (n_heads, F // n_heads)),
              ("adj", adj, (C, N, N)), ("mask", mask, (C, N))]
    if b is not None:
        shapes.append(("b", b, (F,)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"gat_attention_layer: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    tensors = [z] + [t for _, t, _ in shapes]
    dev = z.device
    if any(t.device != dev for t in tensors):
        raise ValueError("gat_attention_layer: inputs on different devices")
    kw = dict(n_heads=n_heads, negative_slope=negative_slope, act=act)
    if dev.type == "cpu":
        return gat_attention_layer_ref(z, a_src, a_dst, adj, mask, b, **kw)
    if dev.type != "cuda":
        raise ValueError(f"gat_attention_layer: unsupported device {dev}")
    if not layer_fits(z, a_src, a_dst, adj, mask, b, n_heads=n_heads):
        raise ValueError(f"gat_attention_layer: the fused kernel does not "
                         f"take z {tuple(z.shape)} {z.dtype} with "
                         f"{n_heads} heads (layer_fits)")
    return launch_layer(z, a_src, a_dst, adj, mask, b, **kw)


def launch_layer(z, a_src, a_dst, adj, mask, b, *, n_heads: int,
                 negative_slope: float, act: str):
    """The fused launch alone, for CUDA tensors of the shapes
    ``gat_attention_layer`` checks and that ``layer_fits`` takes: the
    caller has checked them (``core/program.py``'s grouped step gates on
    ``layer_fits`` once)."""
    build.refuse_grad("gat_attention_layer", z, a_src, a_dst, adj, mask, b)
    C, N, F = z.shape
    dev = z.device
    lib = _lib()
    out = torch.empty((C, N, F), dtype=z.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gat_attention_layer_f32(
            z.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(), adj.data_ptr(),
            mask.data_ptr(), b.data_ptr() if b is not None else None,
            out.data_ptr(), C, N, F, n_heads, float(negative_slope),
            ACTS.index(act), stream)
    if err:
        raise RuntimeError(f"gat_attention_layer: fused slab kernel launch "
                           f"failed (cudaError {err})")
    global launches, fused_launches
    with _count_lock:
        launches += 1
        variant_launches["slab"] += 1
        fused_launches += 1
    if op_analysis.active() is not None:
        c = gat_layer_cost(z, a_src, a_dst, adj, mask, b, n_heads=n_heads)
        op_analysis.note_kernel("gat_attention", c["flops"],
                                c["hbm_bytes"], torch.float32)
    return out


def note_fallback() -> None:
    """Count one attention step that ran unfused on the card
    (``fused_fallbacks``)."""
    global fused_fallbacks
    with _count_lock:
        fused_fallbacks += 1


def gat_layer_cost(z, a_src, a_dst, adj, mask, b=None, *,
                   n_heads: int) -> dict:
    """The fused step's operations and bytes: ``gat_cost``'s on this
    structure, 4 F a row for the two score terms and 3 F a row for the
    bias, activation and mask; z, a_src, a_dst, adj, mask and b read once
    and the output written once."""
    C, N, F = z.shape
    eye = torch.eye(N, dtype=adj.dtype, device=adj.device)
    nnz = int((((torch.sign(adj) + eye) * mask[:, None, :]) > 0).sum())
    moved = sum(t.numel() * t.element_size()
                for t in (z, a_src, a_dst, adj, mask, b) if t is not None) \
        + z.element_size() * C * N * F
    return {"flops": 2.0 * nnz * F + 6.0 * C * n_heads * N * N
            + 7.0 * C * N * F, "hbm_bytes": moved}
