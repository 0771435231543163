"""``DecoupledEngine.infer`` of the PyTorch package against the reference
engine, with the reference's weights carried across: GCN, GraphSAGE and
GAT in forced dense, forced sg and auto mode, dense and packed features,
and a target count that is not a multiple of C. Within the package, the
reference's own bitwise contracts: staged plan() == monolithic prepare()
and overlapped == serial inference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core.config import ServingConfig as JConfig  # noqa: E402
from repro.core.engine import DecoupledEngine as JEngine  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN, init_gnn as j_init  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro.store import StorePolicy as JPolicy  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.gnn.model import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.store import StorePolicy  # noqa: E402

N = 32
C = 4
TARGETS = np.array([3, 8, 8, 40, 121, 7, 64, 90, 2, 300, 17])   # 11: not % C
# three layers of fp32 matmuls summed in another order by XLA and PyTorch
# (and A @ (H @ W) in the kernel path against (A @ H) @ W): 1e-4 relative,
# with the absolute term in units of the output's largest magnitude
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def graphs():
    return (j_get_graph("flickr", scale=0.02, seed=1),
            get_graph("flickr", scale=0.02, seed=1))


def _pair(graphs, kind, mode, impls, features="dense", **kw):
    jg, tg = graphs
    jcfg = JGNN(kind=kind, n_layers=3, receptive_field=N,
                f_in=jg.feature_dim)
    tcfg = GNNConfig(kind=kind, n_layers=3, receptive_field=N,
                     f_in=tg.feature_dim)
    p = j_init(jcfg, jax.random.PRNGKey(7))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
    je = JEngine(jg, jcfg, params=p, config=JConfig(
        batch_size=C, mode=mode, impl=impls[0], num_threads=2,
        store=JPolicy(features=features), **kw))
    te = DecoupledEngine(tg, tcfg, params=tp, config=ServingConfig(
        device="cpu", batch_size=C, mode=mode, impl=impls[1], num_threads=2,
        store=StorePolicy(features=features), **kw))
    return je, te


def _assert_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


class TestEngineParity:
    @pytest.mark.parametrize("impls", [("xla", "torch"), ("pallas", "cuda")])
    @pytest.mark.parametrize("mode", ["dense", "sg", "auto"])
    @pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
    def test_infer_matches_reference(self, graphs, kind, mode, impls):
        je, te = _pair(graphs, kind, mode, impls)
        ops.reset_launch_counts()
        try:
            a, b = je.infer(TARGETS), te.infer(TARGETS)
        finally:
            je.close()
            te.close()
        assert b.embeddings.shape == a.embeddings.shape == (len(TARGETS),
                                                            256)
        assert b.embeddings.dtype == np.float32
        _assert_close(b.embeddings, a.embeddings)
        assert a.decision.modes == b.decision.modes
        assert a.decision.mode == b.decision.mode
        assert b.stats.n_batches == -(-len(TARGETS) // C)
        # CPU tensors: the kernels' plain versions ran, nothing launched
        assert set(ops.launch_counts().values()) == {0}

    @pytest.mark.parametrize("impls", [("xla", "torch"), ("pallas", "cuda")])
    @pytest.mark.parametrize("mode", ["dense", "sg"])
    def test_packed_features(self, graphs, mode, impls):
        je, te = _pair(graphs, "sage", mode, impls, features="packed")
        try:
            a, b = je.infer(TARGETS), te.infer(TARGETS)
            assert te.last_dedup_ratio == je.last_dedup_ratio
        finally:
            je.close()
            te.close()
        _assert_close(b.embeddings, a.embeddings)


@pytest.fixture(scope="module")
def engine(graphs):
    tg = graphs[1]
    cfg = GNNConfig(kind="gat", n_layers=3, receptive_field=N,
                    f_in=tg.feature_dim)
    eng = DecoupledEngine(tg, cfg, config=ServingConfig(
        device="cpu", batch_size=C, mode="sg", impl="cuda", num_threads=2,
        store=StorePolicy(nbr_cache="lru")))
    yield eng
    eng.close()


class TestWithinPackage:
    def test_staged_equals_monolithic(self, engine):
        for targets in (TARGETS[:C], TARGETS[C:2 * C]):
            staged = engine.plan(targets).device
            mono = engine.prepare(targets)
            assert sorted(staged) == sorted(mono)
            for k in staged:
                assert np.array_equal(staged[k], mono[k]), k

    def test_overlap_equals_serial_bitwise(self, engine):
        a = engine.infer(TARGETS, overlap=True).embeddings
        b = engine.infer(TARGETS, overlap=False).embeddings
        assert np.array_equal(a, b)

    def test_streaming_submit_matches_infer(self, engine):
        want = engine.infer(TARGETS[:C], overlap=False).embeddings
        got = engine.submit_chunk(TARGETS[:C]).result(timeout=60)
        assert isinstance(got, torch.Tensor)
        assert np.array_equal(got.numpy(), want)

    def test_tail_padding_and_reports(self, engine):
        assert np.array_equal(engine.pad_targets([5, 6]), [5, 6, 6, 6])
        with pytest.raises(ValueError):
            engine.pad_targets(np.arange(C + 1))
        engine.infer(TARGETS)
        summary = engine.scheduler.stats.summary()
        assert set(summary) == {"schema_version", "latency", "stages",
                                "store"}
        assert set(summary["stages"]["times"]) == {"select", "build", "pack"}
        rep = engine.store_report()
        assert rep["nbr_cache"]["hits"] > 0
        assert rep["features"] == {"strategy": "dense"}

    def test_invalidate_drops_cached_neighborhoods(self, engine):
        engine.infer(TARGETS)
        assert len(engine.nbr_cache) > 0
        dropped = engine.invalidate(np.asarray(TARGETS))
        assert dropped >= len(set(TARGETS.tolist()))

    def test_device_batch_runs(self, graphs, engine):
        from repro_torch.core.subgraph import build_batch
        sb = build_batch(graphs[1], TARGETS[:C], N, e_pad=engine.e_pad,
                         num_threads=1)
        out = engine.run_device(engine.device_batch(sb))
        assert out.shape == (C, 256) and torch.isfinite(out).all()
