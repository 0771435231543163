"""The arithmetic of the two kernels redesigned for Hopper's tensor cores in
bf16, emulated in plain PyTorch on the CPU, where the kernels cannot run.

(a) ``fused_gnn_layer``'s ``wgmma_bf16`` kernel: H.W_neigh and H.W_self as
    bf16 products, which are exact in fp32, summed a 64-wide k-tile at a
    time into a fresh fp32 partial that is added to the fp32 sum; HW kept
    in fp32, split x = hi + lo into tf32 parts with A, and A.HW summed a
    32-wide k-tile at a time from lo.hi + hi.lo + hi.hi; + b, act, * mask
    and one rounding to bf16. On bf16 inputs made with numpy from a seed it
    is held to the reference's ``fused_gnn_layer`` (the Pallas kernel in
    interpret mode, as tests/test_kernels.py runs it on the CPU) at the
    reference's bf16 tolerance (rtol = atol = 2e-2), and to the port's
    plain version's fp32 result within one bf16 ulp (``bf16_reading``, the
    check the kernel meets on the card).
(b) ``flash_attention``'s D=64 and D=128 ``wgmma`` kernels: the online
    softmax over 128-key tiles with P rounded to bf16 before P.V, where O
    is rescaled after the previous tile's P.V is added (O = (O + P_{j-1}
    V_{j-1}) alpha_j), not before it as the (192, 128) template does. Both
    orders pass ``flash_bf16_check`` against the fp32 plain version on the
    shapes of tests/test_torch_flash.py at head widths 64 and 128, and on
    two grouped-query shapes at 128.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_gnn import fused_gnn_layer as j_fused  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.kernels.ref import bf16_reading  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)     # tests/test_kernels.py:14


# -- (a) the fused layer in bf16 ------------------------------------------------


def tf32(x):
    """x rounded to the nearest tf32 (ties away from zero), as the kernel's
    ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _by_k_tiles(x, y, width, products):
    """x @ y summed ``width`` columns of x at a time: each k-tile's
    ``products(x_tile, y_tile)`` is a fresh partial, added to the sum."""
    acc = torch.zeros(x.shape[:-1] + (y.shape[-1],))
    for k0 in range(0, x.shape[-1], width):
        acc = acc + products(x[..., k0:k0 + width], y[..., k0:k0 + width, :])
    return acc


def _three(a, b):
    """a @ b in three tf32 products, lo.hi + hi.lo + hi.hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate_wgmma_bf16(adj, h, wn, ws, b, mask, act):
    """The wgmma_bf16 kernel's arithmetic on bf16 h, wn, ws, b and fp32
    adj, mask: S = H.Ws by 64-wide k-tiles of exact products, then
    S += A.HW by 32-wide k-tiles of three tf32 products, HW = H.Wn by
    64-wide k-tiles; + b, act, * mask, rounded to bf16 once."""
    hf = h.float()
    exact = lambda x, y: x @ y          # noqa: E731  (bf16 x bf16: exact)
    w_any = wn if wn is not None else ws
    acc = torch.zeros(h.shape[:2] + (w_any.shape[1],))
    if ws is not None:
        acc = _by_k_tiles(hf, ws.float(), 64, exact)
    if wn is not None:
        hw = _by_k_tiles(hf, wn.float(), 64, exact)
        acc = acc + _by_k_tiles(adj, hw, 32, _three)
    if b is not None:
        acc = acc + b.float()
    out = fused_gnn.ACTS[act](acc) * mask[..., None]
    return out.to(torch.bfloat16)


def _bf16(a):
    """float32 values rounded to bf16 by JAX, as float32 (exact)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _fused_inputs(c, n, f_in, f_out, seed):
    rng = np.random.default_rng(seed)
    adj = rng.uniform(size=(c, n, n))
    adj = np.where(adj < 0.2, adj, 0.0).astype(np.float32)
    k = rng.integers(n // 2, n + 1, size=c)
    mask = (np.arange(n)[None, :] < k[:, None]).astype(np.float32)
    adj = adj * mask[:, :, None] * mask[:, None, :]
    h = _bf16(rng.standard_normal((c, n, f_in)).astype(np.float32)) \
        * mask[..., None]
    wn, ws = (_bf16(0.1 * rng.standard_normal((f_in, f_out))
                    .astype(np.float32)) for _ in range(2))
    b = _bf16(0.1 * rng.standard_normal(f_out).astype(np.float32))
    return adj, h, wn, ws, b, mask


@pytest.mark.parametrize("act", ["relu", "elu"])
@pytest.mark.parametrize("form", ["neigh+self", "neigh", "self"])
def test_wgmma_bf16_emulation_matches_the_reference(form, act):
    adj, h, wn, ws, b, mask = _fused_inputs(2, 40, 96, 64, seed=40 + 96)
    use_n, use_s = form != "self", form != "neigh"
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = j_fused(jnp.asarray(adj), jb(h), jb(wn) if use_n else None,
                   jb(ws) if use_s else None, jb(b), jnp.asarray(mask),
                   act=act, interpret=True)
    assert want.dtype == jnp.bfloat16
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    args = (torch.from_numpy(adj) if use_n else None, tb(h),
            tb(wn) if use_n else None, tb(ws) if use_s else None, tb(b),
            torch.from_numpy(mask))
    got = emulate_wgmma_bf16(*args, act)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    # and within one bf16 ulp of the plain version's fp32 result, the
    # check the kernel is held to on the card
    plain = fused_gnn.fused_gnn_layer_ref(
        *[a.float() if a is not None else None for a in args], act=act)
    ok, worst, _ = bf16_reading(got, plain)
    assert ok and worst <= 1, worst


def test_wgmma_bf16_emulation_at_the_serving_widths():
    """Fin=512 (eight k-tiles of H.W) and N=256 (eight of A.HW) on a few
    subgraphs: still within one bf16 ulp of the fp32 result."""
    adj, h, wn, ws, b, mask = _fused_inputs(2, 256, 512, 64, seed=7)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    args = (torch.from_numpy(adj), tb(h), tb(wn), tb(ws), tb(b),
            torch.from_numpy(mask))
    got = emulate_wgmma_bf16(*args, "relu")
    plain = fused_gnn.fused_gnn_layer_ref(
        *[a.float() if a is not None else None for a in args])
    assert bf16_reading(got, plain)[0]


# -- (b) the D=64 flash instance's order of operations -------------------------


def emulate_online(q, k, v, causal, rescale_after, round_p=True):
    """The wgmma kernel's online softmax over 128-key tiles: fp32 scores,
    a running max m (masked scores -inf; a row with no finite score yet
    keeps m = -inf and its exponent base 0), p = exp(s - m) rounded to bf16
    for P.V (unless not ``round_p``), l summed from the unrounded p.
    ``rescale_after``: O = (O + P_{j-1} V_{j-1}) alpha_j, the last tile's
    P.V added at the end (the D=64 instance); else O = O alpha_j + P_j V_j
    (the (192, 128) template)."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    scale = 1.0 / D ** 0.5
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -float("inf"))
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, v.shape[-1]))
    pending = None
    for k0 in range(0, k.shape[2], 128):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf[:, :, k0:k0 + 128])
        s = s * scale
        if causal:
            cols = torch.arange(k0, k0 + s.shape[-1])[None, :]
            s = s.masked_fill(cols > rows, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -float("inf"), torch.zeros_like(m_new),
                           m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        pr = p.to(torch.bfloat16).float() if round_p else p
        pv = torch.einsum("bhqk,bhkd->bhqd", pr, vf[:, :, k0:k0 + 128])
        if rescale_after:
            if pending is not None:
                o = o + pending
            o = o * alpha
            pending = pv
        else:
            o = o * alpha + pv
        m = m_new
    if pending is not None:
        o = o + pending
    return (o / l.clamp_min(1e-20)).to(torch.bfloat16)


FLASH_SHAPES = [  # b, h, kh, sq, sk, causal, score scale
    (1, 2, 2, 256, 256, True, 1.0),
    (1, 4, 1, 300, 300, True, 1.0),
    (2, 4, 2, 200, 130, False, 1.0),
    (1, 2, 1, 448, 448, True, 4.0),          # peaked softmax
    (1, 2, 2, 128, 300, False, 0.1),         # nearly uniform
    (1, 3, 3, 1500, 1500, False, 1.0),       # whisper's encoder length
]
GQA_128 = [  # grouped-query shapes at D=128 (8:1 and 5:1)
    (1, 8, 1, 300, 300, True, 1.0),
    (1, 5, 1, 200, 260, False, 1.0),
]


def _shape_id(shape):
    return "-".join(map(str, shape))


# D=64 keeps the ids the cases had before the head width was a parameter
FLASH_CASES = (
    [pytest.param(*c, 64, id=_shape_id(c)) for c in FLASH_SHAPES]
    + [pytest.param(*c, 128, id="d128-" + _shape_id(c))
       for c in FLASH_SHAPES + GQA_128])


@pytest.mark.parametrize("rescale_after", [True, False])
@pytest.mark.parametrize("b,h,kh,sq,sk,causal,scale,d", FLASH_CASES)
def test_both_orders_pass_the_flash_check(b, h, kh, sq, sk, causal, scale,
                                          d, rescale_after):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((b, h, sq, d)) * scale
    k, v = (rng.standard_normal((b, kh, sk, d)) for _ in range(2))
    q, k, v = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
               for a in (q, k, v))
    out = emulate_online(q, k, v, causal, rescale_after)
    p, den, vf = t_flash._parts(q, k, v, causal)
    want = torch.einsum("bhqk,bhkd->bhqd", p, vf).div_(den)
    r = t_flash.flash_bf16_check(out, out.clone(), want,
                                 t_flash.flash_bf16_tol(q, k, v,
                                                        causal=causal))
    assert r["ok"], r
    assert r["worst"] <= 0.75 and abs(r["bias_ulp"]) <= 0.05, r


def test_online_emulation_equals_one_pass_without_rounding():
    """With P kept in fp32 the tiled emulation, in either order, is the
    one-pass softmax to fp32 accuracy: the tiling, not the rounding, is
    what it adds."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 300, 64))
                                .astype(np.float32)) for _ in range(3))
    want = t_flash.flash_attention_ref(q, k, v, causal=True)
    for rescale_after in (True, False):
        got = emulate_online(q, k, v, True, rescale_after, round_p=False)
        torch.testing.assert_close(got.float(), want.to(torch.bfloat16)
                                   .float(), rtol=2.0 ** -7, atol=2e-5)
