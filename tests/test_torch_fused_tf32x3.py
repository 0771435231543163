"""The fused layer's ``tf32x3`` kernel as redesigned for Hopper, shown on
the CPU.

(a) Its weights come split once a weight (``fused_gnn.weight_split``):
    W^T's tf32 hi and lo as [2, Fout, Fin]. The split's bits must equal
    what the kernels' ``tf32_rna`` (``cvt.rna.tf32.f32``) gives: held here
    against the bit formula the CPU tests use for it and against an exact
    rounding in Python's arithmetic.
(b) The kept splits are never stale: an in-place update (through any view)
    makes a fresh split, a new tensor at a freed tensor's address is never
    served the old one, views of one stacked weight share a split made
    once, and an entry leaves with its tensor.
(c) The kernel's order of sums, emulated: each 32-wide k-tile's products
    (lo.hi, hi.lo, hi.hi a k8 step) summed into a fresh partial, the
    partials added into the accumulator tile by tile, S = H.Ws's tiles
    first, then A.HW's with HW split again; + b, act, * mask. The tensor
    cores truncate the partial's sums where this emulation rounds them, so
    it shows the order and the partial width, not the card's bits. It lands
    within 2e-5 of the JAX ``fused_gnn_layer`` (Pallas, interpret mode) and
    of the port's plain version at the shapes of
    tests/test_torch_split.py's three-product test.
"""
import gc
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_gnn import fused_gnn_layer as jax_fused  # noqa: E402
from repro_torch.kernels import fused_gnn as fg  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
BK = 32             # the kernel's k-tile
K8 = 8              # one wgmma's depth in tf32


# -- (a) the split's bits ------------------------------------------------------


def tf32_formula(x):
    """tests/test_torch_split.py's emulation of ``tf32_rna``: half an ulp
    added to the magnitude bits, the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_exact(v: float) -> float:
    """v rounded to the nearest tf32 (10 stored mantissa bits, fp32's
    exponent range; ties away from zero) in exact arithmetic."""
    if v == 0 or math.isinf(v):
        return v
    m, e = math.frexp(abs(v))                 # |v| = m 2^e, 0.5 <= m < 1
    step = 2.0 ** max(e - 11, -136)           # tf32's spacing there
    q = math.floor(abs(v) / step + 0.5) * step
    return math.copysign(q if q < 2.0 ** 128 else math.inf, v)


def _hard_values():
    rng = np.random.default_rng(5)
    one = 1.0 + 2.0 ** -10
    x = [0.0, -0.0, 1.0, one, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
         1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
         2.0 ** -126, 2.0 ** -140, 3 * 2.0 ** -137, 2.0 ** -149,
         -5 * 2.0 ** -149, float(np.finfo(np.float32).max),
         (2.0 - 2.0 ** -10) * 2.0 ** 127, math.inf, -math.inf]
    x += list(rng.standard_normal(2000) * 10.0 ** rng.integers(-30, 30, 2000))
    bits = rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32)
    rand = bits.view(np.float32)
    x += [float(v) for v in rand if np.isfinite(v)]
    return torch.tensor(np.asarray(x, np.float32))


def test_split_bits_equal_the_tf32_rna_emulations():
    x = _hard_values()
    got = fg.tf32_rna(x)
    assert torch.equal(got.view(torch.int32), tf32_formula(x).view(
        torch.int32))
    want = torch.tensor([tf32_exact(float(v)) for v in x],
                        dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    nan = fg.tf32_rna(torch.tensor([math.nan, -math.nan]))
    assert torch.isnan(nan).all()


@pytest.mark.parametrize("fin,fout", [(512, 256), (500, 200), (16, 16)])
def test_weight_split_layout(fin, fout):
    rng = np.random.default_rng(fin)
    w = torch.from_numpy((rng.standard_normal((fin, fout)) * 0.1)
                         .astype(np.float32))
    s = fg.tf32_split(w)
    assert s.shape == (2, fout, fin) and s.is_contiguous()
    hi, lo = s
    wt = w.t()
    assert torch.equal(hi, fg.tf32_rna(wt))
    assert torch.equal(lo, fg.tf32_rna(wt - hi))
    # what hi + lo leaves out is lo's rounding: ~2^-22 of w
    assert ((hi + lo - wt).abs() <= wt.abs() * 2.0 ** -21).all()


# -- (b) the kept splits -------------------------------------------------------


def _weight(seed, shape=(64, 32)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_kept_split_is_reused_while_unchanged():
    w = _weight(1)
    made = fg.splits_made
    a = fg.weight_split(w)
    assert fg.weight_split(w) is a and fg.splits_made == made + 1
    assert torch.equal(a, fg.tf32_split(w))


@pytest.mark.parametrize("update", ["mul_", "view", "copy_", "index"])
def test_in_place_update_makes_a_fresh_split(update):
    w = _weight(2)
    old = fg.weight_split(w)
    if update == "mul_":
        w.mul_(-3.0)
    elif update == "view":
        w[:, :8].add_(1.0)                 # through a view of w
    elif update == "copy_":
        w.copy_(_weight(3))
    else:
        w[5, 7] = 100.0
    new = fg.weight_split(w)
    assert new is not old
    assert torch.equal(new, fg.tf32_split(w))
    assert not torch.equal(new, old)


def test_views_of_a_stacked_weight_share_one_split():
    """The engine's inner layers index a stacked tensor afresh every call:
    each index is a new view object, served the split made the first
    time; an update of the stack makes every layer's split fresh."""
    stack = torch.stack([_weight(s) for s in (4, 5, 6)])
    first = [fg.weight_split(stack[i]) for i in range(3)]
    made = fg.splits_made
    again = [fg.weight_split(stack[i]) for i in range(3)]
    assert all(a is b for a, b in zip(first, again))
    assert fg.splits_made == made
    for i in range(3):
        assert torch.equal(first[i], fg.tf32_split(stack[i]))
    stack[1].mul_(2.0)
    fresh = [fg.weight_split(stack[i]) for i in range(3)]
    assert all(f is not a for f, a in zip(fresh, first))
    assert torch.equal(fresh[1], fg.tf32_split(stack[1]))


def test_new_tensor_at_a_freed_address_gets_its_own_split():
    """A freed weight's entry leaves with it, and a new weight is another
    object: whether or not the allocator gives it the freed address (and
    whatever its ``_version``), it is split afresh."""
    shape = (64, 64)
    reused = 0
    for i in range(10):
        w = torch.empty(shape)
        w.copy_(_weight(100 + i, shape))   # _version 1, as the next one's
        ptr = w.data_ptr()
        fg.weight_split(w)
        key = next(k for k in fg._splits if k[1] == ptr)
        del w
        gc.collect()
        assert key not in fg._splits       # the entry left with its tensor
        w = torch.empty(shape)
        w.copy_(_weight(200 + i, shape))   # _version 1
        reused += w.data_ptr() == ptr
        assert torch.equal(fg.weight_split(w), fg.tf32_split(w))
        del w
    assert reused > 0, "the allocator never reused an address: no case ran"


def test_a_dead_entry_is_never_served():
    w = _weight(7)
    fg.weight_split(w)
    key = next(k for k in fg._splits if k[0] == id(w))
    ref, version, split, stream = fg._splits[key]
    other = _weight(8)
    # an entry whose tensor is another object, at the same key: a miss
    fg._splits[key] = (lambda: other, version, split, stream)
    fresh = fg.weight_split(w)
    assert fresh is not split and torch.equal(fresh, fg.tf32_split(w))


def test_inference_tensors_are_split_every_call():
    with torch.inference_mode():
        w = _weight(9)
    made = fg.splits_made
    a, b = fg.weight_split(w), fg.weight_split(w)
    assert fg.splits_made == made + 2 and a is not b
    assert torch.equal(a, b)


# -- (c) the kernel's order of sums --------------------------------------------


def _split(x):
    hi = fg.tf32_rna(x)
    return hi, fg.tf32_rna(x - hi)


def _steps(x, k_axis):
    """x with its k axis cut into k8 steps (zero-padded), the steps first:
    [K/8, ..., 8 or (8, Nc)] for one batched product per step."""
    K = x.shape[k_axis]
    pad = -K % K8
    if k_axis == -1:
        x = torch.nn.functional.pad(x, (0, pad))
        x = x.unflatten(-1, (-1, K8)).movedim(-2, 0)
    else:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        x = x.unflatten(-2, (-1, K8)).movedim(-3, 0)
    return x.contiguous()


def tile_products(a, b, acc):
    """acc + a @ b as the kernel sums it: ``a`` [C, M, K] split in
    registers, ``b`` [K, Nc] or [C, K, Nc] split (W^T's kept split, or HW
    split in phase 2); per 32-wide k-tile a fresh partial of its k8 steps'
    lo.hi, hi.lo, hi.hi in issue order, then added to ``acc``."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al = _steps(ah, -1), _steps(al, -1)
    bh, bl = _steps(bh, -2), _steps(bl, -2)
    if b.dim() == 2:                       # a weight: the same for every c
        bh, bl = bh[:, None], bl[:, None]
    q = [al @ bh, ah @ bl, ah @ bh]        # each k8 step's three products
    steps = ah.shape[0]
    for t0 in range(0, steps, BK // K8):
        p = None
        for k in range(t0, min(t0 + BK // K8, steps)):
            for prod in q:
                p = prod[k] if p is None else p + prod[k]
        acc = acc + p
    return acc


def emulate_kernel(adj, h, wn, ws, b, mask, act):
    C, N, _ = h.shape
    fout = (wn if wn is not None else ws).shape[1]
    acc = torch.zeros((C, N, fout))
    if ws is not None:
        acc = tile_products(h, ws, acc)
    if wn is not None:
        hw = tile_products(h, wn, torch.zeros((C, N, fout)))
        acc = tile_products(adj, hw, acc)
    if b is not None:
        acc = acc + b
    return fg.ACTS[act](acc) * mask[..., None]


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


@pytest.mark.parametrize("form", ["neigh", "neigh+self", "self"])
@pytest.mark.parametrize("c,n,f_in,f_out", [
    (4, 256, 512, 256), (4, 256, 256, 256), (6, 100, 500, 200),
    (2, 8, 16, 16)])
def test_kernel_order_meets_the_fp32_tolerance(c, n, f_in, f_out, form):
    adj, h, wn, ws, b, mask = _inputs(c, n, f_in, f_out)
    args = {"neigh": (adj, h, wn, None, b, mask),
            "neigh+self": (adj, h, wn, ws, b, mask),
            "self": (None, h, None, ws, b, mask)}[form]
    got = emulate_kernel(*args, "elu")
    torch.testing.assert_close(
        got, fg.fused_gnn_layer_ref(*args, act="elu"), **TOL)
    j = [None if t is None else jnp.asarray(t.numpy()) for t in args]
    j[0] = jnp.asarray(adj.numpy())        # unused without w_neigh
    want = np.asarray(jax_fused(*j, act="elu", interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
