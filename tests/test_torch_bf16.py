"""The three GNN kernels of the PyTorch package in bf16, on the CPU, and
the kernels' variant selectors as pure functions.

The reference's Pallas kernels take bf16 h/z/w (fp32 accumulation, the
output in the input's dtype) and tests/test_kernels.py holds them at
rtol = atol = 2e-2 on the shapes of its dtype parametrizations. Here the
port's wrappers (on CPU tensors: the plain versions) take the same bf16
inputs, made with numpy from a seed, and are held to the Pallas kernels
in interpret mode at that tolerance; on the card the same wrappers launch
the CUDA kernels (tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_gnn import fused_gnn_layer as j_fused  # noqa: E402
from repro.kernels.gat_attention import gat_attention as j_gat  # noqa: E402
from repro.kernels.scatter_gather import \
    scatter_gather_aggregate as j_sg  # noqa: E402
from repro_torch.kernels import fused_gnn, gat_attention, ops  # noqa: E402
from repro_torch.kernels import build, scatter_gather  # noqa: E402
from repro_torch.kernels.ref import bf16_reading, bf16_ulps  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)     # tests/test_kernels.py:14


def _bf16(a):
    """A float32 array rounded to bf16 (JAX's rounding), as float32 (exact),
    so both packages read the same bf16 values."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _held(got, want):
    assert got.dtype == torch.bfloat16
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on CPU tensors: no kernel may launch."""
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNEL_MODULES}


@pytest.mark.parametrize("c,n,f_in,f_out", [
    (1, 8, 16, 16), (2, 64, 128, 256), (3, 128, 512, 256),
    (2, 256, 256, 512), (1, 64, 500, 256)])
def test_fused_gnn_layer_bf16(c, n, f_in, f_out):
    rng = np.random.default_rng(n * f_in + f_out)
    h = _bf16(rng.standard_normal((c, n, f_in)).astype(np.float32))
    adj = rng.uniform(size=(c, n, n))
    adj = np.where(adj < 0.2, adj, 0.0).astype(np.float32)
    k = rng.integers(n // 2, n + 1, size=c)
    mask = (np.arange(n)[None, :] < k[:, None]).astype(np.float32)
    adj = adj * mask[:, :, None] * mask[:, None, :]
    h = h * mask[..., None]
    wn, ws = (_bf16(0.1 * rng.standard_normal((f_in, f_out))
                    .astype(np.float32)) for _ in range(2))
    b = _bf16(0.1 * rng.standard_normal(f_out).astype(np.float32))
    (jh, th), (jwn, twn), (jws, tws), (jb, tb) = map(_pair, (h, wn, ws, b))
    ja, ta = jnp.asarray(adj), torch.from_numpy(adj)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    for self_w in (False, True):
        got = fused_gnn.fused_gnn_layer(ta, th, twn, tws if self_w else None,
                                        tb, tm, act="relu")
        want = j_fused(ja, jh, jwn, jws if self_w else None, jb, jm,
                       act="relu", interpret=True)
        _held(got, want)


@pytest.mark.parametrize("c,n,f,e", [
    (1, 8, 16, 24), (2, 64, 128, 300), (2, 128, 256, 1000),
    (1, 256, 512, 130)])
def test_scatter_gather_aggregate_bf16(c, n, f, e):
    rng = np.random.default_rng(e)
    src = rng.integers(0, n, size=(c, e)).astype(np.int32)
    dst = rng.integers(0, n, size=(c, e)).astype(np.int32)
    w = rng.standard_normal((c, e)).astype(np.float32)
    w[:, e - 7:] = 0.0                        # a padding tail
    h = _bf16(rng.standard_normal((c, n, f)).astype(np.float32))
    jh, th = _pair(h)
    got = scatter_gather.scatter_gather_aggregate(
        *[torch.from_numpy(a) for a in (src, dst, w)], th)
    want = j_sg(*[jnp.asarray(a) for a in (src, dst, w)], jh,
                interpret=True)
    _held(got, want)


@pytest.mark.parametrize("c,n,f,heads", [
    (1, 8, 16, 1), (2, 64, 256, 4), (2, 128, 256, 8), (1, 256, 512, 4)])
def test_gat_attention_bf16(c, n, f, heads):
    rng = np.random.default_rng(n + heads)
    z = _bf16(rng.standard_normal((c, n, f)).astype(np.float32))
    s_src = rng.standard_normal((c, n, heads)).astype(np.float32)
    s_dst = rng.standard_normal((c, n, heads)).astype(np.float32)
    struct = (rng.uniform(size=(c, n, n)) < 0.3).astype(np.float32)
    struct = struct + np.eye(n, dtype=np.float32)[None]
    jz, tz = _pair(z)
    got = gat_attention.gat_attention(
        tz, *[torch.from_numpy(a) for a in (s_src, s_dst, struct)],
        n_heads=heads)
    want = j_gat(jz, *[jnp.asarray(a) for a in (s_src, s_dst, struct)],
                 n_heads=heads, interpret=True)
    _held(got, want)


def test_mixed_dtypes_rejected():
    h = torch.zeros((1, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((16, 16))
    with pytest.raises(TypeError, match="w_neigh"):
        fused_gnn.fused_gnn_layer(torch.zeros((1, 8, 8)), h, w)
    with pytest.raises(TypeError, match="adj"):
        fused_gnn.fused_gnn_layer(torch.zeros((1, 8, 8), dtype=h.dtype), h,
                                  w.to(h.dtype))
    s = torch.zeros((1, 8, 2), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="s_src"):
        gat_attention.gat_attention(h, s, s, torch.ones((1, 8, 8)),
                                    n_heads=2)
    src = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="w must be float32"):
        scatter_gather.scatter_gather_aggregate(
            src, src, torch.zeros((1, 4), dtype=torch.bfloat16), h)


class TestVariants:
    """The selectors the wrappers (and the DSE) call before a launch, as
    pure functions of the shapes."""

    @pytest.mark.parametrize("n,e,want", [
        (256, 18688, "sort"),        # every serving launch at N=256
        (256, 65536, "sort"),        # the 16-bit indices' last count
        (256, 65537, "bucket"),      # past the 16-bit indices
        (1024, 74496, "bucket"),     # forced sg, Flickr-sized, N=1024
        (1024, 100, "bucket"),       # N=1024's histograms alone overflow
        (512, 40000, "sort"),        # fits at 32 columns a block
        (16, 64, "sort")])
    def test_sg_variant(self, n, e, want):
        assert scatter_gather.sg_variant(n, e) == want
        cols = scatter_gather.sort_block_cols(n, e)
        assert (cols > 0) == (want == "sort")
        if cols:
            assert scatter_gather.sort_smem_bytes(n, e, cols) \
                <= build.MAX_SMEM
            if cols < 128:
                assert scatter_gather.sort_smem_bytes(n, e, 2 * cols) \
                    > build.MAX_SMEM

    def test_sort_layout_at_the_serving_shape(self):
        # csrc/scatter_gather.cu: 195,104 bytes at N=256, E=18,688, BF=128
        assert scatter_gather.sort_smem_bytes(256, 18688, 128) == 195_104
        assert scatter_gather.sort_block_cols(256, 18688) == 128

    def test_bf16_goes_to_the_simpler_kernels(self):
        assert fused_gnn.fused_variant(256, 512, True) == "tf32x3"
        assert fused_gnn.fused_variant(256, 512, True, bf16=True) == \
            "cuda_core"
        assert gat_attention.gat_variant(256, 256, 4, aligned=True) == "slab"
        assert gat_attention.gat_variant(256, 256, 4, aligned=True,
                                         bf16=True) == "row"
        # csrc/gat_attention.cu: 111,888 bytes at N=256
        assert gat_attention.slab_smem_bytes(256) == 111_888
        assert gat_attention.row_smem_bytes(320) == 9 * 320 * 4


def test_bf16_reading():
    want = torch.tensor([1.0, 3.0e-6, -2.5, 100.0, float("nan")])
    got = want.to(torch.bfloat16)
    assert bf16_reading(got, want)[0]
    assert bf16_ulps(got, want).max() == 0
    up = got.clone()
    up[0] = 1.0 + 2 ** -7                        # the next bf16 above 1
    assert int(bf16_ulps(up, want)[0]) == 1 and bf16_reading(up, want)[0]
    two = got.clone()
    two[2] = -2.5 * (1 + 2 * 2 ** -7)            # two bf16 steps off
    ok, worst, _ = bf16_reading(two, want)
    assert not ok and worst == 2
    near0 = got.clone()
    near0[1] = 3.5e-6                            # many ulps, but < 2e-5
    assert bf16_reading(near0, want)[0]
    nan = got.clone()
    nan[3] = float("nan")
    assert not bf16_reading(nan, want)[0]
