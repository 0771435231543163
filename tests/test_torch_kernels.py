"""The kernels' plain PyTorch versions against the reference's jnp oracles
(repro.kernels.ref) and its Pallas kernels in interpret mode, on the fp32
shapes of tests/test_kernels.py, at its fp32 tolerance (2e-5). On CPU
tensors the wrappers route to the plain versions and launch nothing; they
reject a wrong dtype or shape on any device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_gnn import fused_gnn_layer as j_fused  # noqa: E402
from repro.kernels.gat_attention import gat_attention as j_gat  # noqa: E402
from repro.kernels.scatter_gather import \
    scatter_gather_aggregate as j_sg  # noqa: E402
from repro_torch.kernels import fused_gnn, gat_attention, ops  # noqa: E402
from repro_torch.kernels import ref, scatter_gather  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _subgraph(rng, c, n, f, edge_frac=0.2):
    """The distribution of tests/test_kernels.py's _rand_subgraph, drawn
    with numpy: features, a sparse positive adjacency, a row mask."""
    h = rng.standard_normal((c, n, f)).astype(np.float32)
    adj = rng.uniform(size=(c, n, n))
    adj = np.where(adj < edge_frac, adj, 0.0).astype(np.float32)
    k = rng.integers(n // 2, n + 1, size=c)
    mask = (np.arange(n)[None, :] < k[:, None]).astype(np.float32)
    adj = adj * mask[:, :, None] * mask[:, None, :]
    return h * mask[..., None], adj, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on CPU tensors: no kernel may launch."""
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNEL_MODULES}


class TestFusedGNN:
    @pytest.mark.parametrize("act", ["relu", "elu", "none"])
    @pytest.mark.parametrize("c,n,f_in,f_out", [
        (1, 8, 16, 16), (2, 64, 128, 256), (3, 128, 512, 256),
        (2, 256, 256, 512), (1, 64, 500, 256),  # unaligned f_in
    ])
    def test_matches_reference(self, c, n, f_in, f_out, act):
        rng = np.random.default_rng(n * f_in + f_out)
        h, adj, mask = _subgraph(rng, c, n, f_in)
        wn = (rng.standard_normal((f_in, f_out)) * 0.1).astype(np.float32)
        ws = (rng.standard_normal((f_in, f_out)) * 0.1).astype(np.float32)
        b = (rng.standard_normal(f_out) * 0.1).astype(np.float32)
        for w_self in (None, ws):
            args = (adj, h, wn, w_self, b, mask)
            got = fused_gnn.fused_gnn_layer(*_t(*args), act=act)
            _close(got, jref.fused_gnn_layer_ref(*_j(*args), act=act))
            _close(got, j_fused(*_j(*args), act=act, interpret=True))
            _close(ref.fused_gnn_layer_ref(*_t(*args), act=act), got)

    def test_self_only_is_plain_matmul(self):
        rng = np.random.default_rng(0)
        h, adj, mask = _subgraph(rng, 2, 32, 64)
        ws = (rng.standard_normal((64, 128)) * 0.1).astype(np.float32)
        got = fused_gnn.fused_gnn_layer(None, *_t(h), None, *_t(ws), None,
                                        *_t(mask), act="none")
        _close(got, np.einsum("cnf,fg->cng", h, ws) * mask[..., None])
        _close(got, j_fused(*_j(adj, h), None, *_j(ws), None, *_j(mask),
                            act="none", interpret=True))

    @pytest.mark.parametrize("block_f", [64, 128, 256, 512])
    def test_block_width_invariance(self, block_f):
        rng = np.random.default_rng(3)
        h, adj, mask = _subgraph(rng, 2, 64, 128)
        w = (rng.standard_normal((128, 512)) * 0.1).astype(np.float32)
        got = fused_gnn.fused_gnn_layer(*_t(adj, h, w), None, None,
                                        *_t(mask), block_f=block_f)
        base = fused_gnn.fused_gnn_layer(*_t(adj, h, w), None, None,
                                         *_t(mask))
        assert torch.equal(got, base)
        _close(got, jref.fused_gnn_layer_ref(*_j(adj, h, w), None, None,
                                             *_j(mask)))

    def test_rejects_bad_inputs(self):
        rng = np.random.default_rng(1)
        h, adj, mask = _subgraph(rng, 2, 16, 32)
        w = (rng.standard_normal((32, 64)) * 0.1).astype(np.float32)
        th, ta, tw, tm = _t(h, adj, w, mask)
        with pytest.raises(TypeError, match="float32"):
            fused_gnn.fused_gnn_layer(ta, th.double(), tw, None, None, tm)
        with pytest.raises(ValueError, match="shape"):
            fused_gnn.fused_gnn_layer(ta, th, tw[:16], None, None, tm)
        with pytest.raises(ValueError, match="shape"):
            fused_gnn.fused_gnn_layer(ta[:, :8], th, tw, None, None, tm)
        with pytest.raises(ValueError, match="block_f"):
            fused_gnn.fused_gnn_layer(ta, th, tw, None, None, tm,
                                      block_f=48)
        with pytest.raises(ValueError, match="both None"):
            fused_gnn.fused_gnn_layer(ta, th, None, None, None, tm)


class TestScatterGather:
    @pytest.mark.parametrize("c,n,f,e", [
        (1, 8, 16, 24), (2, 64, 128, 300), (2, 128, 256, 1000),
        (1, 256, 512, 130),
    ])
    def test_matches_reference(self, c, n, f, e):
        rng = np.random.default_rng(e)
        src = rng.integers(0, n, size=(c, e)).astype(np.int32)
        dst = rng.integers(0, n, size=(c, e)).astype(np.int32)
        w = rng.standard_normal((c, e)).astype(np.float32)
        w[:, e - 7:] = 0.0                 # a padding tail like real batches
        h = rng.standard_normal((c, n, f)).astype(np.float32)
        got = scatter_gather.scatter_gather_aggregate(*_t(src, dst, w, h))
        _close(got, jref.scatter_gather_aggregate_ref(*_j(src, dst, w, h)))
        _close(got, j_sg(*_j(src, dst, w, h), interpret=True))

    def test_accumulation_raw_hazard(self):
        c, n, f, e = 1, 16, 32, 64
        src = torch.zeros((c, e), dtype=torch.int32)
        dst = torch.full((c, e), 3, dtype=torch.int32)
        got = scatter_gather.scatter_gather_aggregate(
            src, dst, torch.ones((c, e)), torch.ones((c, n, f)))
        assert float(got[0, 3, 0]) == e
        assert float(got[0, :3].abs().sum()) == 0.0

    def test_rejects_bad_inputs(self):
        src = torch.zeros((2, 10), dtype=torch.int32)
        h = torch.zeros((2, 8, 4))
        w = torch.zeros((2, 10))
        with pytest.raises(TypeError, match="int32"):
            scatter_gather.scatter_gather_aggregate(src.long(), src, w, h)
        with pytest.raises(TypeError, match="float32"):
            scatter_gather.scatter_gather_aggregate(src, src, w.double(), h)
        with pytest.raises(ValueError, match="disagree"):
            scatter_gather.scatter_gather_aggregate(src, src, w[:, :5], h)


class TestGATAttention:
    @pytest.mark.parametrize("c,n,f,heads", [
        (1, 8, 16, 1), (2, 64, 256, 4), (2, 128, 256, 8), (1, 256, 512, 4),
    ])
    def test_matches_reference(self, c, n, f, heads):
        rng = np.random.default_rng(n + heads)
        z = rng.standard_normal((c, n, f)).astype(np.float32)
        s_src = rng.standard_normal((c, n, heads)).astype(np.float32)
        s_dst = rng.standard_normal((c, n, heads)).astype(np.float32)
        struct = (rng.uniform(size=(c, n, n)) < 0.3).astype(np.float32)
        struct = struct + np.eye(n, dtype=np.float32)[None]
        struct[:, 1, :] = 0.0              # a row with no structure
        args = (z, s_src, s_dst, struct)
        got = gat_attention.gat_attention(*_t(*args), n_heads=heads)
        assert float(got[:, 1].abs().max()) == 0.0
        _close(got, jref.gat_attention_ref(*_j(*args), n_heads=heads))
        _close(got, j_gat(*_j(*args), n_heads=heads, interpret=True))

    def test_rows_sum_to_one(self):
        c, n, f = 1, 32, 64
        got = gat_attention.gat_attention(
            torch.ones((c, n, f)), torch.zeros((c, n, 1)),
            torch.zeros((c, n, 1)), torch.ones((c, n, n)), n_heads=1)
        np.testing.assert_allclose(got.numpy(), 1.0, rtol=1e-5)

    def test_rejects_bad_inputs(self):
        z = torch.zeros((1, 8, 16))
        s = torch.zeros((1, 8, 2))
        st = torch.ones((1, 8, 8))
        with pytest.raises(ValueError, match="divisible"):
            gat_attention.gat_attention(z, s, s, st, n_heads=3)
        with pytest.raises(ValueError, match="shape"):
            gat_attention.gat_attention(z, s, s, st[:, :4], n_heads=2)
        with pytest.raises(TypeError, match="float32"):
            gat_attention.gat_attention(z.double(), s, s, st, n_heads=2)


class TestOps:
    def test_cpu_tensors_take_the_plain_version(self):
        rng = np.random.default_rng(5)
        h, adj, mask = _subgraph(rng, 2, 16, 32)
        w = (rng.standard_normal((32, 64)) * 0.1).astype(np.float32)
        args = _t(adj, h, w, None, None, mask)
        assert torch.equal(ops.fused_gnn_layer(*args),
                           ref.fused_gnn_layer_ref(*args))
        assert ops.launch_counts() == {"fused_gnn_layer": 0,
                                       "scatter_gather_aggregate": 0,
                                       "gat_attention": 0,
                                       "flash_attention": 0}

    def test_reset_launch_counts(self):
        fused_gnn.launches = 3
        ops.reset_launch_counts()
        assert set(ops.launch_counts().values()) == {0}

    def test_caller_launches_count_only_launches(self):
        """A CPU call names its caller yet launches nothing, so counts
        nothing; a reset empties the counts by caller."""
        ops.reset_launch_counts()
        rng = np.random.default_rng(6)
        src = torch.from_numpy(rng.integers(0, 16, (2, 40), dtype=np.int32))
        dst = torch.from_numpy(rng.integers(0, 16, (2, 40), dtype=np.int32))
        w = torch.from_numpy(rng.random((2, 40), dtype=np.float32))
        h = torch.from_numpy(rng.standard_normal((2, 16, 8),
                                                 dtype=np.float32))
        assert torch.equal(
            scatter_gather.scatter_gather_aggregate(src, dst, w, h,
                                                    caller="sums"),
            ref.scatter_gather_aggregate_ref(src, dst, w, h))
        assert scatter_gather.caller_launches == {}
        scatter_gather.caller_launches["sums"] = 3
        ops.reset_launch_counts()
        assert scatter_gather.caller_launches == {}
