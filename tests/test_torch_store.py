"""The device-resident feature store of the PyTorch package, on the CPU.

Mirrors tests/test_store.py's resident-store cases and
tests/test_pipeline.py's automatic repin within the port (resident ==
dense, the host partition's miss path, the miss block shipped at f_in,
hot rows by score, invalidate refreshing resident rows, >= 4x fewer bytes
shipped, repin_every / repin_hit_floor on the completion path, a payload
in flight gathering against its own residency generation), and holds the
port's resident engine against the reference's on the same inputs."""
import copy

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
from repro_torch.core.ini import ini_batch  # noqa: E402
from repro_torch.gnn.model import (GNNConfig, init_gnn,  # noqa: E402
                                   params_from_jax)
from repro_torch.graphs.synthetic import get_graph, zipf_traffic  # noqa: E402
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402
from repro_torch.store import (DeviceFeatureStore, StorePolicy,  # noqa: E402
                               build_feature_source)

C, N = 8, 32
RTOL, ATOL = 1e-4, 1e-5         # tests/test_torch_engine.py's


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=0.005, seed=1)   # ~450 vertices


@pytest.fixture(scope="module")
def cfg(graph):
    return GNNConfig(kind="gcn", n_layers=2, receptive_field=N,
                     f_in=graph.feature_dim)


def _engine(graph, cfg, params=None, seed=0, batch_size=C, **store):
    return DecoupledEngine(graph, cfg, params=params, config=ServingConfig(
        device="cpu", impl="torch", batch_size=batch_size, num_threads=1,
        seed=seed, store=StorePolicy(**store)))


@pytest.fixture(scope="module")
def baseline(graph, cfg):
    eng = _engine(graph, cfg)
    emb = eng.infer(np.arange(24), overlap=False).embeddings
    yield eng, emb
    eng.close()


class TestResidentStore:
    def test_config_takes_resident_refuses_sharded(self, graph):
        ServingConfig(device="cpu", store=StorePolicy(features="resident"))
        with pytest.raises(NotImplementedError, match="item 7"):
            ServingConfig(device="cpu", store=StorePolicy(
                features="sharded", num_shards=2))
        src = build_feature_source(graph, StorePolicy(features="resident"),
                                   512, "cpu")
        assert isinstance(src, DeviceFeatureStore)
        assert src.table.shape == (graph.num_vertices + 1, 512)
        assert src.table.device.type == "cpu"

    def test_resident_store_matches_dense(self, graph, cfg, baseline):
        ref, emb0 = baseline
        eng = _engine(graph, cfg, ref.params, features="resident")
        emb = eng.infer(np.arange(24), overlap=False).embeddings
        np.testing.assert_allclose(emb, emb0, rtol=1e-6, atol=1e-6)
        eng.close()

    def test_resident_transfer_savings_at_least_4x(self, graph, cfg,
                                                   baseline):
        ref, _ = baseline
        eng = _engine(graph, cfg, ref.params, features="resident")
        eng.infer(np.arange(16), overlap=False)
        s = eng.scheduler.stats
        assert s.bytes_dense >= 4 * s.bytes_shipped
        rep = eng.store_report()
        assert rep["features"]["resident_fraction"] == 1.0
        assert rep["features"]["miss_rows_shipped"] == 0
        eng.close()

    def test_partial_residency_miss_path(self, graph, cfg, baseline):
        ref, emb0 = baseline
        budget = 64 * (graph.feature_dim * 4)     # ~64 resident rows
        eng = _engine(graph, cfg, ref.params, features="resident",
                      hbm_budget_bytes=budget)
        emb = eng.infer(np.arange(24), overlap=False).embeddings
        np.testing.assert_allclose(emb, emb0, rtol=1e-6, atol=1e-6)
        rep = eng.store_report()["features"]
        assert 0 < rep["resident_fraction"] < 1.0
        assert rep["miss_rows_shipped"] > 0
        eng.close()

    def test_invalidate_refreshes_resident_rows(self, graph, cfg):
        g = copy.deepcopy(graph)              # don't mutate the fixture
        eng = _engine(g, cfg, features="resident", nbr_cache="lru")
        t = np.arange(8)
        before = eng.infer(t, overlap=False).embeddings
        g.features[:8] += 1.0                 # feature update at targets
        eng.invalidate(np.arange(8))
        after = eng.infer(t, overlap=False).embeddings
        assert np.abs(after - before).max() > 0
        # a fresh dense engine over the updated graph agrees: the rows
        # were re-uploaded, not served from a stale table
        ref = _engine(g, cfg, eng.params)
        np.testing.assert_allclose(
            after, ref.infer(t, overlap=False).embeddings,
            rtol=1e-6, atol=1e-6)
        ref.close()
        eng.close()

    def test_report_surfaces_store_stats(self, graph, cfg):
        eng = _engine(graph, cfg, batch_size=4, features="resident",
                      nbr_cache="lru")
        srv = GNNServer(eng, max_wait_s=0.005)
        srv.start()
        reqs = [srv.submit(int(t)) for t in [0, 1, 2, 3, 0, 1, 2, 3]]
        srv.drain(reqs, timeout=120)
        srv.stop()
        m = srv.report()["models"]["default"]
        for key in ("bytes_shipped", "transfer_ratio", "cache_hit_rate",
                    "dedup_ratio", "features", "nbr_cache"):
            assert key in m["store"]
        assert m["store"]["bytes_shipped"] > 0
        assert m["store"]["transfer_ratio"] < 0.5   # indices, not rows
        assert m["store"]["features"]["strategy"] == "resident"
        eng.close()


class TestPartialResidencyStore:
    def test_budget_zero_keeps_all_host_side(self, graph):
        st = DeviceFeatureStore(graph, graph.feature_dim, "cpu",
                                budget_bytes=0)
        assert st.num_resident == 0
        payload, _ = st.host_payload([np.array([0, 1])], 4)
        assert payload["miss_feats"].shape[0] == 2
        np.testing.assert_array_equal(payload["miss_feats"][0],
                                      graph.features[0])

    def test_miss_block_ships_at_f_in_not_f_pad(self, graph):
        f_in = graph.feature_dim                  # 500
        st = DeviceFeatureStore(graph, 512, "cpu", budget_bytes=8 * 512 * 4)
        nls = ini_batch(graph, [0, 1], 16, num_threads=1)
        payload, _ = st.host_payload(nls, 16)
        assert payload["miss_feats"].shape[1] == f_in
        feats = st.device_feats(payload).numpy()
        assert feats.shape == (2, 16, 512)        # padded device-side
        np.testing.assert_array_equal(feats[0, 0, :f_in],
                                      graph.features[nls[0][0]])
        np.testing.assert_array_equal(feats[..., f_in:], 0.0)

    def test_hot_rows_selected_by_score(self, graph):
        score = np.zeros(graph.num_vertices)
        score[[3, 7]] = 1.0
        st = DeviceFeatureStore(graph, graph.feature_dim, "cpu",
                                budget_bytes=3 * graph.feature_dim * 4,
                                hot_scores=score)
        assert st.num_resident == 2
        assert st.slot_of[3] > 0 and st.slot_of[7] > 0


@pytest.fixture(scope="module")
def pipe_graph():
    return get_graph("flickr", scale=0.02, seed=1)   # test_pipeline.py's


class TestAutoRepin:
    """tests/test_pipeline.py's ``TestAutoRepin`` at its shapes (N=16,
    C=4, the ~1.8k-vertex graph)."""
    N, C = 16, 4

    @pytest.fixture
    def graph(self, pipe_graph):
        return pipe_graph

    @pytest.fixture
    def cfg(self, pipe_graph):
        return GNNConfig(kind="gcn", n_layers=2, receptive_field=self.N,
                         f_in=pipe_graph.feature_dim)

    def _stream(self, eng, chunks):
        return [eng.submit_chunk(c).result().cpu().numpy() for c in chunks]

    def test_fires_every_k_batches(self, graph, cfg):
        params = init_gnn(cfg, 5, device="cpu")
        budget = 48 * graph.feature_dim * 4
        traffic = zipf_traffic(graph, 40, a=1.1, seed=3)
        chunks = [traffic[i:i + self.C] for i in range(0, 40, self.C)]
        eng = _engine(graph, cfg, params, batch_size=self.C,
                      features="resident", hbm_budget_bytes=budget,
                      nbr_cache="lru", repin_every=3)
        outs = self._stream(eng, chunks)
        eng.scheduler.flush()
        eng.drain_repins()           # rebalances run on their own worker
        assert eng.auto_repins == len(chunks) // 3
        assert eng._fsource.repins == eng.auto_repins
        assert eng.store_report()["auto_repins"] == eng.auto_repins
        # the same store without the trigger: bitwise the same outputs
        ref = _engine(graph, cfg, params, batch_size=self.C,
                      features="resident", hbm_budget_bytes=budget,
                      nbr_cache="lru")
        for a, b in zip(outs, self._stream(ref, chunks)):
            np.testing.assert_array_equal(a, b)
        ref.close()
        eng.close()

    def test_hit_floor_trigger(self, graph, cfg):
        budget = 16 * graph.feature_dim * 4   # tiny: most lookups miss
        eng = _engine(graph, cfg, seed=5, batch_size=self.C,
                      features="resident", hbm_budget_bytes=budget,
                      repin_hit_floor=1.0)
        eng.infer(np.array([3, 8, 8, 40, 121, 7, 64, 90, 2, 300, 17]),
                  overlap=False)               # the serial path fires it
        assert eng.auto_repins >= 1
        eng.drain_repins()
        assert eng._fsource.repins == eng.auto_repins
        assert eng._floor_wait > 1             # backs off, never met
        eng.close()

    def test_repin_promotes_observed_mass(self, graph, cfg):
        params = init_gnn(cfg, 6, device="cpu")
        eng = _engine(graph, cfg, params, batch_size=self.C,
                      features="resident",
                      hbm_budget_bytes=64 * graph.feature_dim * 4,
                      nbr_cache="lru")
        traffic = zipf_traffic(graph, 64, a=1.1, seed=4)
        emb0 = eng.infer(traffic[:32], overlap=False).embeddings
        st = eng._fsource
        lk0, res0 = st.lookups, st.resident_lookups
        rep = eng.repin()
        assert rep["resident_rows"] > 0 and "mass_covered" in rep
        emb1 = eng.infer(traffic[:32], overlap=False).embeddings
        np.testing.assert_array_equal(emb0, emb1)  # residency-invariant
        after = (st.resident_lookups - res0) / (st.lookups - lk0)
        assert after >= (res0 / lk0) - 1e-9
        with pytest.raises(ValueError, match="repin"):
            _engine(graph, cfg).repin()            # dense: no repin
        eng.close()

    def test_inflight_snapshot_survives_repin(self, graph, cfg):
        eng = _engine(graph, cfg, seed=7, features="resident",
                      hbm_budget_bytes=48 * graph.feature_dim * 4,
                      nbr_cache="lru")
        node_lists = eng.plan(np.arange(C)).node_lists
        payload, _ = eng._fsource.host_payload(node_lists, self.N)
        eng.infer(zipf_traffic(graph, 32, a=1.2, seed=5), overlap=False)
        for _ in range(3):
            eng.repin()                        # several generations later
        stale = eng._fsource.device_feats(payload)
        fresh_payload, _ = eng._fsource.host_payload(node_lists, self.N)
        assert int(fresh_payload["store_gen"]) > int(payload["store_gen"])
        fresh = eng._fsource.device_feats(fresh_payload)
        assert torch.equal(stale, fresh)
        eng.close()


@pytest.mark.parametrize("kind", ["gcn", "gat"])
@pytest.mark.parametrize("budget_rows", [None, 64])
def test_resident_engine_matches_the_reference(kind, budget_rows):
    """The port's resident engine against the reference's resident engine
    on the same graph, weights and targets, fully and partly resident."""
    jg = j_get_graph("flickr", scale=0.005, seed=1)
    tg = get_graph("flickr", scale=0.005, seed=1)
    kw = dict(kind=kind, n_layers=2, receptive_field=N, f_in=jg.feature_dim)
    budget = None if budget_rows is None else \
        budget_rows * jg.feature_dim * 4
    p = j_init(JGNN(**kw), jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
    je = JEngine(jg, JGNN(**kw), params=p, config=JConfig(
        batch_size=C, impl="xla", num_threads=1,
        store=JPolicy(features="resident", hbm_budget_bytes=budget)))
    te = DecoupledEngine(tg, GNNConfig(**kw), params=tp, config=ServingConfig(
        device="cpu", batch_size=C, impl="torch", num_threads=1,
        store=StorePolicy(features="resident", hbm_budget_bytes=budget)))
    targets = np.array([3, 8, 8, 40, 121, 7, 64, 90, 2, 300, 17])
    a, b = je.infer(targets), te.infer(targets)
    ja, tb = je.store_report()["features"], te.store_report()["features"]
    assert (ja["resident_rows"], ja["miss_rows_shipped"], ja["lookups"]) == \
        (tb["resident_rows"], tb["miss_rows_shipped"], tb["lookups"])
    assert a.stats.bytes_shipped == b.stats.bytes_shipped
    je.close()
    te.close()
    scale = max(1.0, float(np.abs(a.embeddings).max()))
    np.testing.assert_allclose(b.embeddings, a.embeddings, rtol=RTOL,
                               atol=ATOL * scale)
