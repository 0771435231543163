"""The numerics of the two redesigned GNN kernels, shown on the CPU.

(a) ``scatter_gather_aggregate`` keeps its oracle's meaning for weight-0
    edges: ``repro.kernels.ref.scatter_gather_aggregate_ref`` sums
    ``w * h[src]`` by ``segment_sum``, so a weight-0 edge whose source row
    holds inf or NaN puts NaN at its destination, in that column only. The
    port's plain version (what the wrappers run on CPU tensors, and what the
    CUDA kernel is held to on the card) must put NaN in exactly the same
    places and agree elsewhere at 2e-5. It is not held against the Pallas
    kernel in interpret mode: that kernel routes edges through one-hot
    matmuls, which multiply 0 * inf for every edge of the column and so make
    the whole column NaN, an artefact of the routing, not the function.
(b) The fused layer's tf32x3 kernel splits every operand x into
    hi = tf32(x) and lo = tf32(x - hi) and sums lo.hi + hi.lo + hi.hi in
    fp32; a CPU emulation of exactly that (bit operations for the rounding)
    lands within 2e-5 of ``fused_gnn_layer_ref`` at the GPU tests' shapes,
    while hi.hi alone (plain TF32) does not: the design can meet the fp32
    tolerance, and the tolerance can tell the two apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fused_gnn, scatter_gather  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


# -- (a) weight-0 edges from non-finite sources ------------------------------


def _padded_edges(rng, c, n, e, live):
    """Random live edges, then a weight-0 tail pointing at vertex n - 1, as
    ``core/subgraph.py`` pads every subgraph's edge list."""
    src = rng.integers(0, n, (c, e)).astype(np.int32)
    dst = rng.integers(0, n, (c, e)).astype(np.int32)
    w = rng.standard_normal((c, e)).astype(np.float32)
    src[:, live:] = dst[:, live:] = n - 1
    w[:, live:] = 0.0
    return src, dst, w


@pytest.mark.parametrize("c,n,f,e,live", [
    (2, 16, 32, 64, 40), (3, 64, 128, 400, 150), (2, 256, 512, 2000, 700)])
def test_weight0_edges_match_the_oracle(c, n, f, e, live):
    rng = np.random.default_rng(n + e)
    src, dst, w = _padded_edges(rng, c, n, e, live)
    w[0, 3] = 0.0                         # a weight-0 edge inside the list
    w[-1, 5] = -0.0
    h = rng.standard_normal((c, n, f)).astype(np.float32)
    h[0, n - 1, 1] = np.inf               # the padding's source row
    h[-1, n - 1, f - 1] = np.nan
    h[0, src[0, 3], 2] = -np.inf          # the inner weight-0 edge's source
    h[-1, src[-1, 5], 0] = np.nan
    got = scatter_gather.scatter_gather_aggregate(
        *[torch.from_numpy(a) for a in (src, dst, w, h)]).numpy()
    want = np.asarray(jref.scatter_gather_aggregate_ref(
        *[jnp.asarray(a) for a in (src, dst, w, h)]))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    # the NaN lands in the poisoned columns of the weight-0 destinations
    assert np.isnan(want[0, n - 1, 1]) and np.isnan(want[-1, n - 1, f - 1])
    assert np.isnan(want[0, dst[0, 3], 2])


def test_weight0_edges_add_nothing_for_finite_features():
    rng = np.random.default_rng(7)
    src, dst, w = _padded_edges(rng, 2, 32, 300, 120)
    h = rng.standard_normal((2, 32, 64)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (src, dst, w, h)]
    live = scatter_gather.scatter_gather_aggregate(
        t[0][:, :120].contiguous(), t[1][:, :120].contiguous(),
        t[2][:, :120].contiguous(), t[3])
    assert torch.equal(scatter_gather.scatter_gather_aggregate(*t), live)


# -- (b) the 3xTF32 split ------------------------------------------------------


def tf32(x):
    """x rounded to the nearest tf32 (10 mantissa bits, ties away from
    zero), as the kernel's ``cvt.rna.tf32.f32``: add half an ulp to the
    magnitude bits and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _mm(a, b, products):
    """a @ b from tf32 parts: ``products`` 3 sums lo.hi + hi.lo + hi.hi
    (the kernel's order), 1 takes hi.hi alone. Each tf32 product is exact in
    fp32; the sums round in fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if products == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def emulate_fused(adj, h, wn, ws, b, mask, act, products):
    """The tf32x3 kernel's arithmetic: HW = H @ Wn and S = H @ Ws from split
    operands, HW split again, out = act(S + A @ HW + b) * mask."""
    acc = torch.zeros(h.shape[:2] + ((wn if wn is not None else ws)
                                     .shape[1],))
    if ws is not None:
        acc = _mm(h, ws, products)
    if wn is not None:
        acc = acc + _mm(adj, _mm(h, wn, products), products)
    if b is not None:
        acc = acc + b
    return fused_gnn.ACTS[act](acc) * mask[..., None]


def _inputs(c, n, f_in, f_out):
    rng = np.random.default_rng(n * f_in)
    a = rng.uniform(size=(c, n, n))
    a = np.where(a < 0.2, a, 0.0).astype(np.float32)
    k = rng.integers(n // 2, n + 1, size=c)
    mask = (np.arange(n)[None, :] < k[:, None]).astype(np.float32)
    a = a * mask[:, :, None] * mask[:, None, :]
    h = rng.standard_normal((c, n, f_in)).astype(np.float32) * mask[..., None]
    w = [(rng.standard_normal((f_in, f_out)) * 0.1).astype(np.float32)
         for _ in range(2)]
    b = (rng.standard_normal(f_out) * 0.1).astype(np.float32)
    return [torch.from_numpy(x) for x in (a, h, w[0], w[1], b, mask)]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                          # a tf32 value
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, one, 3.0e-3])
    got = tf32(x)
    assert got[0] == one and got[1] == -one and got[2] == 1.0
    assert got[3] == one
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = _split(x)
    assert torch.equal(hi + (x - hi), x)           # x - hi is exact


@pytest.mark.parametrize("form", ["neigh", "neigh+self", "self"])
@pytest.mark.parametrize("c,n,f_in,f_out", [
    (4, 256, 512, 256), (4, 256, 256, 256), (6, 100, 500, 200),
    (2, 8, 16, 16)])
def test_three_products_meet_the_fp32_tolerance(c, n, f_in, f_out, form):
    adj, h, wn, ws, b, mask = _inputs(c, n, f_in, f_out)
    args = {"neigh": (adj, h, wn, None, b, mask),
            "neigh+self": (adj, h, wn, ws, b, mask),
            "self": (None, h, None, ws, b, mask)}[form]
    want = fused_gnn.fused_gnn_layer_ref(*args, act="elu")
    torch.testing.assert_close(emulate_fused(*args, "elu", 3), want, **TOL)
    one = emulate_fused(*args, "elu", 1)
    assert not torch.allclose(one, want, **TOL)


def test_fused_variant_by_shape():
    """Every serving shape takes the tf32x3 kernel; rows that TMA cannot
    stride (not a multiple of 16 bytes), N past one block's 256 rows or an
    unaligned tensor take the CUDA-core kernel."""
    v = fused_gnn.fused_variant
    assert v(256, 512, True) == v(256, 256, True) == "tf32x3"
    assert v(256, 256, False) == v(100, 500, True) == "tf32x3"
    assert v(37, 45, True) == v(70, 130, True) == "cuda_core"
    assert v(70, 128, True) == "cuda_core" and v(70, 128, False) == "tf32x3"
    assert v(257, 512, False) == "cuda_core"
    assert v(256, 512, True, aligned=False) == "cuda_core"
