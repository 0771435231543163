"""Host layer of the PyTorch package against the JAX reference, bitwise:
both run the same numpy code, so graphs, PPR node lists, built batches
and the Select/Build/Pack device arrays must be identical."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core.config import ServingConfig as JConfig  # noqa: E402
from repro.core.engine import DecoupledEngine as JEngine  # noqa: E402
from repro.core.ini import ini_batch as j_ini_batch  # noqa: E402
from repro.core.subgraph import build_batch as j_build_batch  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN, init_gnn as j_init  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro.graphs.synthetic import zipf_traffic as j_zipf  # noqa: E402
from repro.store import StorePolicy as JPolicy  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.ini import ini_batch  # noqa: E402
from repro_torch.core.subgraph import build_batch  # noqa: E402
from repro_torch.gnn.model import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.graphs.synthetic import get_graph, zipf_traffic  # noqa: E402
from repro_torch.store import StorePolicy  # noqa: E402

N = 32
C = 4


@pytest.fixture(scope="module")
def graphs():
    return (j_get_graph("flickr", scale=0.02, seed=1),
            get_graph("flickr", scale=0.02, seed=1))


def _equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b


class TestGraph:
    def test_get_graph_bitwise(self, graphs):
        jg, tg = graphs
        for f in ("indptr", "indices", "features", "labels"):
            _equal(getattr(jg, f), getattr(tg, f))
        assert jg.name == tg.name

    def test_zipf_traffic_bitwise(self, graphs):
        jg, tg = graphs
        _equal(j_zipf(jg, 50, seed=3), zipf_traffic(tg, 50, seed=3))


class TestSelectBuild:
    @pytest.mark.parametrize("with_frontier", [False, True])
    def test_ini_batch_bitwise(self, graphs, with_frontier):
        jg, tg = graphs
        targets = [0, 7, 19, 101, 7]
        a = j_ini_batch(jg, targets, N, 0.15, 1e-4, num_threads=1,
                        with_frontier=with_frontier)
        b = ini_batch(tg, targets, N, 0.15, 1e-4, num_threads=1,
                      with_frontier=with_frontier)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if with_frontier:
                _equal(x[0], y[0])
                _equal(x[1], y[1])
            else:
                _equal(x, y)

    def test_build_batch_bitwise(self, graphs):
        jg, tg = graphs
        a = j_build_batch(jg, [1, 5, 9, 13], N, e_pad=N * (N - 1),
                          num_threads=1)
        b = build_batch(tg, [1, 5, 9, 13], N, e_pad=N * (N - 1),
                        num_threads=1)
        for f in a.__dataclass_fields__:
            _equal(getattr(a, f), getattr(b, f))


def _engines(graphs, kind, mode, impls, store):
    jg, tg = graphs
    jcfg = JGNN(kind=kind, n_layers=2, receptive_field=N,
                f_in=jg.feature_dim)
    tcfg = GNNConfig(kind=kind, n_layers=2, receptive_field=N,
                     f_in=tg.feature_dim)
    p = j_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
    je = JEngine(jg, jcfg, params=p, config=JConfig(
        batch_size=C, mode=mode, impl=impls[0], num_threads=1,
        store=JPolicy(**store)))
    te = DecoupledEngine(tg, tcfg, params=tp, config=ServingConfig(
        device="cpu", batch_size=C, mode=mode, impl=impls[1],
        num_threads=1, store=StorePolicy(**store)))
    return je, te


class TestPlanDevice:
    @pytest.mark.parametrize("store", [
        {}, {"features": "packed"}, {"nbr_cache": "lru"}])
    @pytest.mark.parametrize("mode", ["dense", "sg"])
    @pytest.mark.parametrize("impls", [("xla", "torch"), ("pallas", "cuda")])
    def test_plan_device_bitwise(self, graphs, impls, mode, store):
        je, te = _engines(graphs, "gcn", mode, impls, store)
        try:
            assert je.f_pad == te.f_pad and je.e_pad == te.e_pad
            assert je.adj_keys == te.adj_keys
            assert je.needs_edges == te.needs_edges
            for targets in ([3, 8, 8, 40], [8, 3, 40, 2]):
                a, b = je.plan(targets), te.plan(targets)
                assert sorted(a.device) == sorted(b.device)
                for k in a.device:
                    _equal(a.device[k], b.device[k])
                for f in ("nbr_hits", "nbr_misses", "build_hits",
                          "build_misses", "n_vertices", "n_edges"):
                    assert getattr(a, f) == getattr(b, f), f
        finally:
            je.close()
            te.close()

    def test_scheduler_host_metrics_match(self, graphs):
        je, te = _engines(graphs, "sage", "sg", ("xla", "torch"),
                          {"features": "packed"})
        try:
            targets = np.arange(0, 30, 3)
            sa = je.infer(targets, overlap=False).stats
            sb = te.infer(targets, overlap=False).stats
            for f in ("bytes_shipped", "bytes_dense", "n_batches",
                      "batch_edges_total", "last_dedup_ratio"):
                assert getattr(sa, f) == getattr(sb, f), f
            assert set(sa.summary()) == set(sb.summary())
        finally:
            je.close()
            te.close()
