"""Flash attention (forward): the CUDA kernels ``csrc/flash_attention.cu``
and their plain PyTorch version.

Per (batch, head): scores ``q . k^T * (1/sqrt(D))`` summed in fp32; when
causal, ``row >= col`` (top-left aligned, counted from 0) or -1e30;
softmax with the denominator clamped at 1e-20; ``@ v``; the result in q's
type. Grouped-query attention is read in place: k and v carry Kh heads,
H % Kh == 0, and query head h reads KV head h // (H // Kh). v may be
narrower than q and k (Dv <= D; MLA's core: q/k 192, v 128), and the
output is then Dv wide.

Replaces the TPU kernel ``flash_attention`` (src/repro/kernels/
flash_attention.py, ``_kernel``), which walks key blocks in a sequential
grid dimension with the online-softmax statistics in VMEM scratch. Bound
on an H100: operations (causal S=8192, D=128 does ~2,050 operations a
byte). Two kernels, chosen by ``flash_variant`` from the dtype and head
dim before launch:

- ``"wgmma"`` (bf16, (D, Dv) in ``WGMMA_SHAPES``: (64, 64), (128, 128)
  and MLA's (192, 128); every attention config of the registry):
  tensor-core products for Q.K^T and P.V, K/V tiles fed by TMA through a
  ring, P rounded to bf16 before P.V (as the reference's model paths and
  SDPA do). (64, 64) runs a design of its own for whisper's shapes: three
  consumer warpgroups of 64 query rows, a persistent grid over (b*h, 192
  rows) items, Q.K^T of the next tile issued before the softmax of the
  last ends, O rescaled after the previous tile's P.V.
- ``"cuda_core"`` (fp32 at any D up to 256, bf16 at other widths): fp32
  products and sums on the CUDA cores, P kept in fp32. It takes v at D:
  for Dv < D the wrapper zero-pads v and slices the output (a padded
  column adds nothing to a real one). (192, 192) stays here: at two
  stages the wgmma kernel would need 246,840 bytes of shared memory.

Both skip tiles wholly above the diagonal and mask ragged tiles, so,
unlike the TPU wrapper, any sequence length works.

The wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches the chosen kernel or raises. ``launches`` counts all
launches, ``variant_launches`` each kernel's. ``flash_bf16_tol`` and
``flash_bf16_check`` hold the wgmma kernel to its plain version;
``flash_cost`` is the reference's analytic cost model, kept beside it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_analysis

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("wgmma", "cuda_core")
WGMMA_SHAPES = ((64, 64), (128, 128), (192, 128))     # (D, Dv)
MAX_Q_BLOCKS = 65535        # grid limit in y: query blocks (wgmma), B*H

launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def flash_variant(dtype: torch.dtype, head_dim: int, v_dim=None) -> str:
    """The kernel that takes inputs of ``dtype`` with q and k
    ``head_dim`` wide and v ``v_dim`` wide (``head_dim`` when None)."""
    v_dim = head_dim if v_dim is None else v_dim
    if dtype == torch.bfloat16 and (head_dim, v_dim) in WGMMA_SHAPES:
        return "wgmma"
    return "cuda_core"


def _parts(q, k, v, causal):
    """fp32 unnormalized probabilities exp(s - max) [B,H,Sq,Sk], their
    clamped row sums [B,H,Sq,1] and v in fp32 with each KV head repeated
    for its query heads [B,H,Sk,Dv] (Dv <= D: the scale is q's 1/sqrt(D))."""
    D = q.shape[-1]
    Sq, Sk = q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    s.mul_(1.0 / D ** 0.5)
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, NEG_INF)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    den = p.sum(dim=-1, keepdim=True).clamp_min_(1e-20)
    return p, den, vf


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain PyTorch version, fp32 throughout: unnormalized exp(s - max),
    then ``(p @ v) / max(l, 1e-20)``, cast to q's type."""
    p, den, vf = _parts(q, k, v, causal)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).div_(den).to(q.dtype)


def flash_bf16_tol(q, k, v, *, causal: bool = True):
    """Per-element tolerance of the wgmma kernel against the fp32 plain
    version: ``2^-7 (A + |ref|) + 2e-5`` with ``A = sum_c p |v| / l``.
    Rounding each p to bf16 moves it by at most 2^-8 of itself, so the
    output by at most 2^-8 A: the 2^-7 A term is twice that; 2^-7 |ref| is
    one output ulp."""
    p, den, vf = _parts(q, k, v, causal)
    ref = torch.einsum("bhqk,bhkd->bhqd", p, vf).div_(den)
    a = torch.einsum("bhqk,bhkd->bhqd", p, vf.abs()).div_(den)
    return a.add_(ref.abs_()).mul_(2.0 ** -7).add_(2e-5)


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (2^-133 at 0)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


BIAS_ULP = 0.1              # largest |mean signed error| in ulps


def flash_bf16_check(out, again, ref, tol) -> dict:
    """The wgmma kernel's three checks against the fp32 plain version
    ``ref`` (float32, unrounded) at the per-element ``tol``:

    (a) every element within ``tol`` (``worst`` <= 1);
    (b) the mean signed error ``sign(ref) (out - ref)`` over the elements,
        in units of their mean bf16 ulp, within +-0.1 (a truncating store
        reads about -0.5). The mean of each element's error in its own ulp
        is not used: where ref is near 0 that ratio is unbounded, and the
        mean of 10^7 such terms is set by a few of them;
    (c) ``again``, a second launch on the same inputs, bitwise equal.
    """
    got, want = out.float(), ref.float()
    diff = got - want
    worst = float((diff.abs() / tol).max())
    bias = float((torch.sign(want) * diff).sum() / bf16_ulp(want).sum())
    same = bool(torch.equal(out, again))
    ok = worst <= 1.0 and abs(bias) <= BIAS_ULP and same
    return dict(max_abs_err=float(diff.abs().max()), worst=worst,
                bias_ulp=bias, repeatable=same, ok=ok)


_typed = None       # the library whose argument types are set


def _lib():
    """The kernels' library, its functions' argument types set once a
    library (ctypes checks them on every call; setting them per call cost
    host time)."""
    global _typed
    lib = build.load("flash_attention")
    if lib is _typed:
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                        ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_wgmma_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                              i, ctypes.c_float, i, p]
    lib.flash_attention_wgmma_fwd.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i]
    lib.flash_attention_smem_bytes.restype = i
    _typed = lib
    return lib


def _launch_on(idx: int, launch):
    """Runs ``launch(stream)`` on device ``idx``'s current stream (its raw
    handle: the public Stream object costs a few microseconds a call); the
    device context is switched only when ``idx`` is not the current
    device."""
    if idx == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return launch(torch._C._cuda_getCurrentRawStream(idx))


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B,H,Sq,D]; k [B,Kh,Sk,D] and v [B,Kh,Sk,Dv] with H % Kh == 0
    and Dv <= D, all float32 or all bfloat16. Returns [B,H,Sq,Dv] in q's
    type. (Each tensor attribute read costs a fraction of a microsecond,
    and whisper's decoder calls take ~20 us on the card: the checks read
    each once.)"""
    qs, ks, vs = q.shape, k.shape, v.shape
    if len(qs) != 4 or len(ks) != 4 or len(vs) != 4:
        raise ValueError("flash_attention: q, k, v must be [B,H,S,D]")
    B, H, Sq, D = qs
    Kh, Sk, Dv = ks[1], ks[2], vs[3]
    if (ks != (B, Kh, Sk, D) or vs[:3] != ks[:3] or Dv > D or Kh == 0
            or H % Kh):
        raise ValueError(f"flash_attention: q {tuple(qs)}, k "
                         f"{tuple(ks)} and v {tuple(vs)} do not "
                         f"match (k must be [B,Kh,Sk,D] and v [B,Kh,Sk,Dv] "
                         f"with Dv <= D, H % Kh == 0)")
    if Sq == 0 or Sk == 0 or D == 0 or Dv == 0:
        raise ValueError("flash_attention: empty sequence or head dim")
    dt = q.dtype
    if dt not in DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {dt}, {k.dtype}, "
                        f"{v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: inputs on different devices")
    if not q.is_cuda:
        if dev.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal)
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        build.refuse_grad("flash_attention", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    variant = flash_variant(q.dtype, D, Dv)
    lib = _lib()
    scale = 1.0 / D ** 0.5
    if variant == "wgmma":
        ptr = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        if (ptr[0] | ptr[1] | ptr[2]) & 15:
            raise ValueError("flash_attention: the wgmma kernel needs "
                             "16-byte aligned inputs")
        if -(-Sq // 128) > MAX_Q_BLOCKS:
            raise ValueError(f"flash_attention: Sq={Sq} exceeds the grid's "
                             f"{MAX_Q_BLOCKS} query blocks")
        out = q.new_empty((B, H, Sq, Dv))
        launch = lambda s: lib.flash_attention_wgmma_fwd(  # noqa: E731
            *ptr, out.data_ptr(), B, H, Kh, Sq, Sk, D, Dv, scale,
            int(bool(causal)), s)
    else:
        if B * H > MAX_Q_BLOCKS:
            raise ValueError(f"flash_attention: B*H={B * H} exceeds the "
                             f"grid's {MAX_Q_BLOCKS} blocks in y")
        if lib.flash_attention_smem_bytes(D) > build.MAX_SMEM:
            raise ValueError(f"flash_attention: D={D} needs "
                             f"{lib.flash_attention_smem_bytes(D)} bytes of "
                             f"shared memory, more than a block has "
                             f"({build.MAX_SMEM})")
        # the kernel takes v at D: a narrower v is zero-padded, the
        # output sliced back below
        vp = v if Dv == D else torch.nn.functional.pad(v, (0, D - Dv))
        out = torch.empty_like(q)
        launch = lambda s: lib.flash_attention_fwd(  # noqa: E731
            q.data_ptr(), k.data_ptr(), vp.data_ptr(), out.data_ptr(), B, H,
            Kh, Sq, Sk, D, scale, int(bool(causal)), DTYPES[q.dtype], s)
    err = _launch_on(dev.index, launch)
    if err:
        raise RuntimeError(f"flash_attention: {variant} kernel launch "
                           f"failed (error {err})")
    global launches
    with _count_lock:
        launches += 1
        variant_launches[variant] += 1
    if op_analysis.active() is not None:
        c = flash_cost(B, H, Sq, Sk, D, causal=causal,
                       bytes_per=q.element_size(), v_dim=Dv)
        op_analysis.note_kernel(
            "flash_attention", c["flops"], c["hbm_bytes"],
            torch.bfloat16 if variant == "wgmma" else torch.float32)
    return out if Dv == D else out[..., :Dv].contiguous()


def flash_cost(B, H, Sq, Sk, D, causal=True, bytes_per=2, v_dim=None):
    """Analytic roofline terms of the function (the reference's
    ``flash_cost``): operations, halved when causal and square, and the
    bytes of q, k, v and the output each moved once. With ``v_dim``, v
    and the output are that wide: Q.K^T at D and P.V at ``v_dim``,
    2·B·H·Sq·Sk·(D + v_dim)·frac operations."""
    frac = 0.5 if causal and Sq == Sk else 1.0
    v_dim = D if v_dim is None else v_dim
    flops = 2.0 * B * H * Sq * Sk * (D + v_dim) * frac
    hbm = bytes_per * B * H * (Sq + Sk) * (D + v_dim)
    return {"flops": flops, "hbm_bytes": hbm}
