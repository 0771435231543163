"""``gat_attention``'s semantics and the slab kernel's list walk, shown on the
CPU.

(a) The oracle, ``repro.kernels.ref.gat_attention_ref``, and the Pallas
    kernel both end in ``attn @ z`` over all N rows, so a weight of 0
    (outside a destination's structure, or a structural exp that
    underflowed) times an inf or NaN in z gives NaN. The port's plain
    version (what the wrapper runs on CPU tensors, and what the CUDA kernels
    are held to on the card) puts NaN in exactly the same places as both,
    and agrees with them elsewhere at 2e-5; so do rows whose structural
    scores are all -inf (0, because the max also sees the masked entries'
    -1e30), empty rows (0) and fully dense rows.
(b) A numpy model of the slab kernel's algorithm (``slab_model``, in
    ``gat_slab_model.py``): per
    (subgraph, head, slice of at most 64 columns) the structure as a bitmap,
    each row's structural columns as a list in ascending j, the max over the
    list seeded at -1e30 where the list is shorter than N, exp, one
    reciprocal of the clamped sum, the weighted sum over the list with zero
    weights included (even and odd entries summed apart, then added, as
    the two half-warps do), and NaN in the columns where a z row outside
    the row's structure is not finite. It matches the oracle on the inputs
    of (a), and each fault planted in it (weight-0 entries skipped, the NaN
    of rows outside the structure dropped, each list's last entry dropped,
    the max seeded at -inf) does not: the inputs tell the faults apart.
(c) ``gat_variant``: the shapes each kernel takes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gat_attention import gat_attention as j_gat  # noqa: E402
from repro_torch.kernels import gat_attention, ops  # noqa: E402

from gat_slab_model import FAULTS, slab_model  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, c, n, f, heads, density=0.2):
    """Random scores and z, a random structure with self loops, and the edge
    cases: row 1 empty, row 2 fully dense, row 3's structural scores all
    -inf, row 4 fully dense with all scores -inf."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((c, n, f)).astype(np.float32)
    s_src = rng.standard_normal((c, n, heads)).astype(np.float32)
    s_dst = rng.standard_normal((c, n, heads)).astype(np.float32)
    struct = (rng.uniform(size=(c, n, n)) < density).astype(np.float32)
    struct += np.eye(n, dtype=np.float32)[None]
    struct[:, 1, :] = 0.0
    struct[:, 2, :] = 1.0
    s_dst[:, 3, :] = -np.inf
    struct[:, 4, :] = 1.0
    s_dst[:, 4, :] = -np.inf
    return z, s_src, s_dst, struct


def _poison(z, s_src, struct):
    """inf and NaN in z rows outside some destinations' structure, and an
    inf behind a structural weight that underflows to exactly 0."""
    z, s_src = z.copy(), s_src.copy()
    c, n, f = z.shape
    z[0, 5, 1] = np.inf
    z[-1, n - 1, f - 1] = np.nan
    z[0, 6, f // 2] = -np.inf
    i, j = 7, 8                          # edge 8 -> 7, score ~ -2000
    struct = struct.copy()
    struct[0, i, j] = 1.0
    s_src[0, j, :] = -1e4
    z[0, j, 0] = np.inf
    return z, s_src, struct


def _all_three(args, heads):
    t = [torch.from_numpy(a) for a in args]
    plain = gat_attention.gat_attention(*t, n_heads=heads).numpy()
    j = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jref.gat_attention_ref(*j, n_heads=heads))
    pallas = np.asarray(j_gat(*j, n_heads=heads, interpret=True))
    return plain, oracle, pallas


def _same(got, want):
    """NaN in the same places, infinities equal, the rest within TOL."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


SHAPES = [(1, 16, 8, 2), (2, 32, 64, 4), (2, 64, 128, 1), (1, 48, 96, 3)]


# -- (a) the plain version, the oracle and the Pallas kernel ------------------


@pytest.mark.parametrize("c,n,f,heads", SHAPES)
def test_nonfinite_z_gives_nan_where_the_oracle_does(c, n, f, heads):
    z, s_src, s_dst, struct = _inputs(n + heads, c, n, f, heads)
    z, s_src, struct = _poison(z, s_src, struct)
    with np.errstate(invalid="ignore"):
        plain, oracle, pallas = _all_three((z, s_src, s_dst, struct), heads)
    assert np.isnan(oracle).any()
    _same(plain, oracle)
    _same(pallas, oracle)
    # every destination outside row 5's structure: NaN in column 1
    outside = struct[0, :, 5] <= 0
    assert np.isnan(oracle[0, outside, 1]).all()
    # the structural weight that underflowed: NaN, not inf, at 8 -> 7
    assert np.isnan(oracle[0, 7, 0])


def test_one_inf_in_z_poisons_its_column_outside_its_row():
    """C=1, N=16, F=8, 2 heads; the identity plus edge 3 -> 0; z[0, 7, 1] =
    inf: column 1 is NaN in the 15 rows other than row 7, inf at row 7."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((1, 16, 8)).astype(np.float32)
    z[0, 7, 1] = np.inf
    s = rng.standard_normal((2, 1, 16, 2)).astype(np.float32)
    struct = np.eye(16, dtype=np.float32)[None].copy()
    struct[0, 0, 3] = 1.0
    with np.errstate(invalid="ignore"):
        plain, oracle, pallas = _all_three((z, s[0], s[1], struct), 2)
    for got in (plain, oracle, pallas):
        col = got[0, :, 1]
        assert np.isinf(col[7]) and col[7] > 0
        assert np.isnan(np.delete(col, 7)).all()
        assert np.isfinite(np.delete(got[0], 1, axis=1)).all()


@pytest.mark.parametrize("c,n,f,heads", SHAPES)
def test_edge_rows(c, n, f, heads):
    args = _inputs(2 * n + heads, c, n, f, heads)
    with np.errstate(invalid="ignore"):
        plain, oracle, pallas = _all_three(args, heads)
    _same(plain, oracle)
    _same(pallas, oracle)
    assert (oracle[:, 1] == 0).all()             # empty
    assert (oracle[:, 3] == 0).all()             # structural scores all -inf
    assert np.isnan(oracle[:, 4]).all()          # dense, all -inf
    assert np.isfinite(oracle[:, 2]).all()       # dense


# -- (b) the slab kernel's algorithm ------------------------------------------


@pytest.mark.parametrize("c,n,f,heads", SHAPES)
def test_slab_model_matches_the_oracle(c, n, f, heads):
    z, s_src, s_dst, struct = _inputs(3 * n + heads, c, n, f, heads)
    z, s_src, struct = _poison(z, s_src, struct)
    args = (z, s_src, s_dst, struct)
    oracle = np.asarray(jref.gat_attention_ref(
        *[jnp.asarray(a) for a in args], n_heads=heads))
    with np.errstate(invalid="ignore", over="ignore"):
        _same(slab_model(*args, heads), oracle)


@pytest.mark.parametrize("fault", FAULTS)
def test_slab_model_faults_disagree_with_the_oracle(fault):
    c, n, f, heads = SHAPES[1]
    z, s_src, s_dst, struct = _inputs(7, c, n, f, heads)
    z, s_src, struct = _poison(z, s_src, struct)
    args = (z, s_src, s_dst, struct)
    oracle = np.asarray(jref.gat_attention_ref(
        *[jnp.asarray(a) for a in args], n_heads=heads))
    with np.errstate(invalid="ignore", over="ignore"):
        got = slab_model(*args, heads, fault=fault)
    with pytest.raises(AssertionError):
        _same(got, oracle)


def test_slab_model_long_rows():
    """Rows longer than a warp (the serving batch's long rows hold most of
    its entries): N=256 at density 0.5, one head of 256 columns in four
    slices."""
    z, s_src, s_dst, struct = _inputs(11, 1, 256, 256, 1, density=0.5)
    args = (z, s_src, s_dst, struct)
    oracle = np.asarray(jref.gat_attention_ref(
        *[jnp.asarray(a) for a in args], n_heads=1))
    with np.errstate(invalid="ignore", over="ignore"):
        _same(slab_model(*args, 1), oracle)


# -- (c) the kernel each shape takes ------------------------------------------


@pytest.mark.parametrize("n,f,heads,aligned,variant", [
    (256, 256, 4, True, "slab"),        # the serving shape
    (256, 256, 1, True, "slab"),        # head width 256: four slices
    (256, 256, 2, True, "slab"),
    (256, 256, 8, True, "slab"),        # head width 32
    (200, 256, 4, True, "slab"),
    (8, 16, 4, True, "slab"),           # head width 4
    (320, 256, 4, True, "row"),         # N > 256
    (257, 256, 4, True, "row"),
    (254, 256, 4, True, "row"),         # N not a multiple of 4
    (256, 24, 4, True, "row"),          # head width 6
    (256, 256, 4, False, "row"),        # z or struct not 16-byte aligned
])
def test_gat_variant(n, f, heads, aligned, variant):
    assert gat_attention.gat_variant(n, f, heads,
                                      aligned=aligned) == variant


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _inputs(5, 1, 16, 8, 2)]
    got = gat_attention.gat_attention(*args, n_heads=2)
    torch.testing.assert_close(
        got, gat_attention.gat_attention_ref(*args, n_heads=2),
        equal_nan=True, rtol=0, atol=0)
    assert gat_attention.launches == 0
    assert gat_attention.variant_launches == {"slab": 0, "row": 0}
