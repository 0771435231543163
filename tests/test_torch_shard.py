"""The sharded feature store of the PyTorch package, on the CPU.

Mirrors every test of tests/test_shard.py within the port under
impl="torch" on device="cpu" (cross-shard gather bitwise equal to the
unsharded resident store, placement policies, uneven budgets with the host
miss block, online PPR-mass repin(), the per-shard accounting through
SchedulerStats and GNNServer.report(), feature updates), then holds the
port's sharded engine against the reference's on the same graph, params and
targets, and checks ``shard_devices``."""
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
from repro_torch.distributed.sharding import shard_devices  # noqa: E402
from repro_torch.gnn.model import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.graphs.synthetic import get_graph, zipf_traffic  # noqa: E402
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402
from repro_torch.store import ShardedFeatureStore, StorePolicy  # noqa: E402

TARGETS = np.arange(24)
RTOL, ATOL = 1e-4, 1e-5         # tests/test_torch_engine.py's


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=0.005, seed=1)   # ~450 vertices


@pytest.fixture(scope="module")
def cfg(graph):
    return GNNConfig(kind="gcn", n_layers=2, receptive_field=32,
                     f_in=graph.feature_dim)


def _engine(graph, cfg, params=None, batch_size=8, **store):
    return DecoupledEngine(graph, cfg, params=params, config=ServingConfig(
        device="cpu", impl="torch", batch_size=batch_size, num_threads=1,
        store=StorePolicy(**store)))


@pytest.fixture(scope="module")
def baseline(graph, cfg):
    """Unsharded full-resident store: the bitwise reference."""
    eng = _engine(graph, cfg, features="resident")
    emb = eng.infer(TARGETS, overlap=False).embeddings
    yield eng, emb
    eng.close()


def _sharded(graph, cfg, params, **kw):
    kw.setdefault("num_shards", 2)
    return _engine(graph, cfg, params, features="sharded", **kw)


class TestPolicyValidation:
    def test_sharded_needs_num_shards(self):
        with pytest.raises(ValueError, match="num_shards"):
            StorePolicy(features="sharded")

    def test_shard_knobs_need_sharded(self):
        with pytest.raises(ValueError, match="sharded"):
            StorePolicy(num_shards=2)
        with pytest.raises(ValueError, match="sharded"):
            StorePolicy(features="resident", shard_budget_bytes=1024)

    def test_bad_placement_rejected(self):
        with pytest.raises(ValueError, match="placement"):
            StorePolicy(features="sharded", num_shards=2,
                        placement="rendezvous")

    def test_describe_includes_shard_fields(self):
        p = StorePolicy(features="sharded", num_shards=4,
                        placement="range", shard_budget_bytes=(1, 2, 3, 4))
        d = p.describe()
        assert d["num_shards"] == 4 and d["placement"] == "range"
        assert d["shard_budget_bytes"] == [1, 2, 3, 4]


class TestCrossShardGather:
    @pytest.mark.parametrize("placement", ["hash", "range"])
    @pytest.mark.parametrize("num_shards", [2, 4])
    def test_bitwise_equal_to_unsharded(self, graph, cfg, baseline,
                                        placement, num_shards):
        ref, emb0 = baseline
        eng = _sharded(graph, cfg, ref.params, num_shards=num_shards,
                       placement=placement)
        emb = eng.infer(TARGETS, overlap=False).embeddings
        np.testing.assert_array_equal(emb, emb0)
        rep = eng.store_report()["features"]
        assert rep["resident_fraction"] == 1.0    # union covers the matrix
        assert rep["miss_rows_shipped"] == 0
        assert min(rep["shard_rows"]) > 0
        assert rep["cross_shard_rows"] > 0
        assert rep["simulated"] is True and rep["devices"] == \
            ["cpu"] * num_shards
        eng.close()

    def test_uneven_budgets_with_miss_partition(self, graph, cfg,
                                                baseline):
        ref, emb0 = baseline
        row = graph.feature_dim * 4
        eng = _sharded(graph, cfg, ref.params, placement="range",
                       shard_budget_bytes=(96 * row, 32 * row))
        emb = eng.infer(TARGETS, overlap=False).embeddings
        np.testing.assert_array_equal(emb, emb0)
        rep = eng.store_report()["features"]
        assert rep["shard_rows"] == [96, 32]      # uneven split honored
        assert 0 < rep["resident_fraction"] < 1.0
        assert rep["miss_rows_shipped"] > 0       # host fallback exercised
        eng.close()

    def test_miss_block_ships_at_f_in(self, graph, cfg):
        row = graph.feature_dim * 4
        store = ShardedFeatureStore(graph, f_pad=512, device="cpu",
                                    num_shards=2, budget_bytes=16 * row)
        nls = ini_batch(graph, [0, 1], 32, num_threads=1)
        payload, _ = store.host_payload(nls, 32)
        assert payload["miss_feats"].shape[1] == graph.feature_dim  # 500
        feats = store.device_feats(payload).numpy()
        assert feats.shape == (2, 32, 512)
        np.testing.assert_array_equal(feats[0, 0, :graph.feature_dim],
                                      graph.features[nls[0][0]])
        np.testing.assert_array_equal(feats[..., graph.feature_dim:], 0.0)

    def test_single_shard_degenerates_to_resident(self, graph, cfg,
                                                  baseline):
        ref, emb0 = baseline
        eng = _sharded(graph, cfg, ref.params, num_shards=1)
        emb = eng.infer(TARGETS, overlap=False).embeddings
        np.testing.assert_array_equal(emb, emb0)
        assert eng.store_report()["features"]["cross_shard_rows"] == 0
        eng.close()


class TestRepin:
    def test_repin_promotes_hot_rows_and_stays_bitwise(self, graph, cfg,
                                                       baseline):
        ref, emb0 = baseline
        row = graph.feature_dim * 4
        eng = _sharded(graph, cfg, ref.params, placement="hash",
                       shard_budget_bytes=64 * row)
        traffic = zipf_traffic(graph, 128, a=1.1, seed=2)
        eng.infer(traffic, overlap=False)          # accumulate PPR mass
        st = eng._fsource
        lk0, res0 = st.lookups, st.resident_lookups
        report = eng.repin()
        assert report["promoted"] >= 0 and "mass_balance_after" in report
        assert st.report()["repins"] == 1
        emb = eng.infer(TARGETS, overlap=False).embeddings
        np.testing.assert_array_equal(emb, emb0)   # placement-invariant
        lk1, res1 = st.lookups, st.resident_lookups
        eng.infer(traffic, overlap=False)
        before = res0 / lk0
        after = (st.resident_lookups - res1) / (st.lookups - lk1)
        assert after >= before - 1e-9
        eng.close()

    def test_repin_requires_repinnable_store(self, graph, cfg, baseline):
        ref, _ = baseline
        rep = ref.repin()
        assert rep["resident_rows"] >= 0
        eng = _engine(graph, cfg, ref.params)      # dense: nothing resident
        with pytest.raises(ValueError, match="repin"):
            eng.repin()
        eng.close()

    def test_inflight_placement_snapshot_survives_repin(self, graph, cfg,
                                                        baseline):
        ref, _ = baseline
        eng = _sharded(graph, cfg, ref.params, num_shards=2)
        node_lists = ini_batch(graph, [int(t) for t in TARGETS[:8]], 32,
                               num_threads=1)
        payload, _ = eng._fsource.host_payload(node_lists, 32)
        eng.infer(zipf_traffic(graph, 64, a=1.1, seed=3), overlap=False)
        eng.repin()                                # new generation
        feats = eng._fsource.device_feats(payload).numpy()
        want = np.zeros_like(feats)
        for i, nl in enumerate(node_lists):
            k = min(len(nl), 32)
            want[i, :k, :graph.feature_dim] = graph.features[nl[:k]]
        np.testing.assert_array_equal(feats, want)
        eng.close()


class TestShardObservability:
    def test_scheduler_accumulates_per_shard_bytes(self, graph, cfg,
                                                   baseline):
        ref, _ = baseline
        eng = _sharded(graph, cfg, ref.params, num_shards=2)
        eng.infer(TARGETS, overlap=False)
        s = eng.scheduler.stats
        assert len(s.shard_bytes) == 2 and all(b > 0 for b in s.shard_bytes)
        assert s.shard_balance >= 1.0
        assert s.summary()["shards"]["balance"] >= 1.0
        assert sum(s.shard_bytes) < s.bytes_dense
        eng.close()

    def test_server_report_surfaces_shard_stats(self, graph, cfg):
        eng = _engine(graph, cfg, batch_size=4, features="sharded",
                      num_shards=2, nbr_cache="lru")
        srv = GNNServer(eng, max_wait_s=0.005)
        srv.start()
        reqs = [srv.submit(int(t)) for t in [0, 1, 2, 3, 0, 1, 2, 3]]
        srv.drain(reqs, timeout=120)
        srv.stop()
        m = srv.report()["models"]["default"]
        assert len(m["shards"]["bytes"]) == 2
        assert m["shards"]["balance"] >= 1.0
        st = m["store"]["features"]
        assert st["strategy"] == "sharded" and st["num_shards"] == 2
        for key in ("shard_rows", "shard_lookups", "mass_balance",
                    "cross_shard_rows", "placement", "simulated"):
            assert key in st
        eng.close()

    def test_graph_update_refreshes_shard_rows(self, graph, cfg):
        g = copy.deepcopy(graph)
        eng = _engine(g, cfg, features="sharded", num_shards=2,
                      nbr_cache="lru")
        t = np.arange(8)
        before = eng.infer(t, overlap=False).embeddings
        g.features[:8] += 1.0
        eng.invalidate(np.arange(8))
        after = eng.infer(t, overlap=False).embeddings
        assert np.abs(after - before).max() > 0
        fresh = _engine(g, cfg, eng.params)
        np.testing.assert_allclose(
            after, fresh.infer(t, overlap=False).embeddings,
            rtol=1e-6, atol=1e-6)
        fresh.close()
        eng.close()


class TestShardDevices:
    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_cpu_shards_are_simulated(self, k):
        assert shard_devices(k, "cpu") == [torch.device("cpu")] * k

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the no-card path does "
                        "not apply")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_devices(2)


class TestAgainstReference:
    """The port's sharded engine against the reference's sharded engine on
    the same graph, params and targets."""

    @pytest.mark.parametrize("placement,budget_rows", [
        ("hash", None), ("range", (96, 32))])
    def test_sharded_engine_matches_reference(self, placement,
                                              budget_rows):
        jg = j_get_graph("flickr", scale=0.005, seed=1)
        tg = get_graph("flickr", scale=0.005, seed=1)
        kw = dict(kind="gcn", n_layers=2, receptive_field=32,
                  f_in=jg.feature_dim)
        budget = None if budget_rows is None else \
            tuple(r * jg.feature_dim * 4 for r in budget_rows)
        p = j_init(JGNN(**kw), jax.random.PRNGKey(2))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
        je = JEngine(jg, JGNN(**kw), params=p, config=JConfig(
            batch_size=8, impl="xla", num_threads=1,
            store=JPolicy(features="sharded", num_shards=2,
                          placement=placement, shard_budget_bytes=budget)))
        te = _engine(tg, GNNConfig(**kw), tp, features="sharded",
                     num_shards=2, placement=placement,
                     shard_budget_bytes=budget)
        res = _engine(tg, GNNConfig(**kw), tp, features="resident")
        a = je.infer(TARGETS, overlap=False)
        b = te.infer(TARGETS, overlap=False)
        c = res.infer(TARGETS, overlap=False)
        ja = je.store_report()["features"]
        tb = te.store_report()["features"]
        for key in ("shard_rows", "shard_lookups", "cross_shard_rows",
                    "miss_rows_shipped", "lookups", "resident_rows"):
            assert ja[key] == tb[key], key
        assert je.scheduler.stats.shard_bytes == te.scheduler.stats.shard_bytes
        # the repin of both stores moves the same rows
        jr, tr = je.repin(), te.repin()
        assert (jr["promoted"], jr["demoted"], jr["moved"]) == \
            (tr["promoted"], tr["demoted"], tr["moved"])
        for e in (je, te, res):
            e.close()
        np.testing.assert_allclose(b.embeddings, a.embeddings, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(b.embeddings, c.embeddings)
