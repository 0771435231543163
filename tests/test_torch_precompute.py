"""The offline precompute tier of the PyTorch package, on the CPU.

Mirrors every test of tests/test_precompute.py within the port (the tier's
answers equal the online path's under full coverage, edge updates demote
exactly the dependency ball, refreshed rows equal a fresh build, mixed
batches split and rejoin, the artifact refuses a mutated deployment), under
impl="torch" on device="cpu" (and impl="cuda", whose wrappers take their
plain versions for CPU tensors, where the reference runs its kernels too).
Then holds the port against the reference on the same graph, seed and
params: the offline propagation, the dependency closure, the tier's
bookkeeping, the compact chunk form of the Aggregate against the
reference's chunk function, artifacts read across the two packages, and
the tier beside the other planes (sharded store, the loopback transport,
telemetry)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core.program import lower as j_lower  # noqa: E402
from repro.core.program import specialize as j_specialize  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN, init_gnn as j_init  # noqa: E402
from repro.graphs.synthetic import (DatasetSpec as JSpec,  # noqa: E402
                                    make_graph as j_make_graph)
from repro.precompute import propagate as j_prop  # noqa: E402
from repro.precompute.artifact import \
    save_artifact as j_save_artifact  # noqa: E402
from repro.precompute.tier import EmbeddingTier as JTier  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.program import lower, specialize  # noqa: E402
from repro_torch.core.report_schema import (SCHEMA,  # noqa: E402
                                            SCHEMA_VERSION)
from repro_torch.gnn.model import (GNNConfig, init_gnn,  # noqa: E402
                                   params_from_jax)
from repro_torch.graphs.synthetic import DatasetSpec, make_graph  # noqa: E402
from repro_torch.precompute import (EmbeddingTier,  # noqa: E402
                                    PrecomputeArtifactError,
                                    PrecomputeConfig, PrecomputeError,
                                    agg_hops, dependency_closure,
                                    layer_major_embeddings)
from repro_torch.precompute.propagate import (_LocalCSR,  # noqa: E402
                                              chunk_aggregate,
                                              compact_chunk)
from repro_torch.store import StorePolicy  # noqa: E402

SPEC = DatasetSpec("tiny", 64, 4.0, 16, 4)
J_SPEC = JSpec("tiny", 64, 4.0, 16, 4)
V = 64
C = 8
TARGETS = np.arange(24)
RTOL, ATOL = 1e-4, 1e-5


def _graph(seed=0):
    return make_graph(SPEC, seed=seed)


def _cfg(kind="sgc", n_layers=2):
    # receptive_field = V + tiny ppr_eps: the online subgraph is the FULL
    # graph, so online and offline compute the same function
    return GNNConfig(kind=kind, n_layers=n_layers, receptive_field=V,
                     f_in=SPEC.feature_dim, f_hidden=32, ppr_eps=1e-9,
                     readout="target")


def _sc(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("impl", "torch")
    kw.setdefault("batch_size", C)
    kw.setdefault("e_pad", 8192)
    kw.setdefault("num_threads", 1)
    return ServingConfig(**kw)


# -- the mirrors of tests/test_precompute.py ---------------------------------


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("kind", ["sgc", "appnp"])
def test_tier_equals_online(kind, impl):
    g = _graph()
    cfg = _cfg(kind)
    params = init_gnn(cfg, 0, device="cpu")
    with DecoupledEngine(g, cfg, params=params,
                         config=_sc(impl=impl)) as online, \
            DecoupledEngine(g, cfg, params=params, config=_sc(
                impl=impl, precompute=PrecomputeConfig())) as hybrid:
        a = online.infer(TARGETS).embeddings
        b = hybrid.infer(TARGETS).embeddings
        rep = hybrid.precompute_report()
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert rep["hits"] == len(TARGETS) and rep["misses"] == 0


def test_tier_equals_online_forced_sg():
    g = _graph()
    cfg = _cfg("sgc")
    params = init_gnn(cfg, 0, device="cpu")
    with DecoupledEngine(g, cfg, params=params,
                         config=_sc(mode="sg")) as online, \
            DecoupledEngine(g, cfg, params=params, config=_sc(
                mode="sg", precompute=PrecomputeConfig())) as hybrid:
        np.testing.assert_allclose(online.infer(TARGETS).embeddings,
                                   hybrid.infer(TARGETS).embeddings,
                                   rtol=RTOL, atol=ATOL)


def test_demotes_exact_dependency_ball():
    g = _graph(seed=3)
    cfg = _cfg("gcn", n_layers=2)
    sc = _sc(precompute=PrecomputeConfig(auto_refresh=False))
    with DecoupledEngine(g, cfg, config=sc) as eng:
        hops = agg_hops(eng.program)
        assert hops == 2            # one Aggregate per executed layer
        v0 = 11
        eng.precompute.on_invalidate([v0])
        ball, frontier = {v0}, {v0}
        for _ in range(hops):
            nxt = set()
            for u in frontier:
                nxt.update(g.indices[g.indptr[u]:g.indptr[u + 1]].tolist())
            frontier = nxt - ball
            ball |= nxt
        _, fresh = eng.precompute.tier.lookup(np.arange(V))
        assert set(np.flatnonzero(~fresh).tolist()) == ball


def test_post_refresh_equals_fresh_build():
    g = _graph(seed=4)
    cfg = _cfg("sgc")
    params = init_gnn(cfg, 0, device="cpu")
    sc = _sc(precompute=PrecomputeConfig(auto_refresh=False))
    with DecoupledEngine(g, cfg, params=params, config=sc) as eng:
        g.apply_edge_updates(insert=[(5, 9), (2, 40)])
        assert eng.precompute_report()["demotions"] > 0
        eng.precompute.drain()
        rep = eng.precompute_report()
        assert rep["refresh_backlog"] == 0 and rep["fresh"] == V
        got = eng.infer(TARGETS).embeddings
        with DecoupledEngine(g, cfg, params=params, config=_sc(
                precompute=PrecomputeConfig())) as fresh:
            want = fresh.infer(TARGETS).embeddings
    np.testing.assert_allclose(want, got, rtol=RTOL, atol=ATOL)


def test_mixed_batch_splits_and_rejoins():
    g = _graph(seed=5)
    cfg = _cfg("sgc")
    params = init_gnn(cfg, 0, device="cpu")
    sc = _sc(precompute=PrecomputeConfig(auto_refresh=False))
    with DecoupledEngine(g, cfg, params=params, config=sc) as hybrid, \
            DecoupledEngine(g, cfg, params=params,
                            config=_sc()) as online:
        hybrid.precompute.on_invalidate([7])
        got = hybrid.infer(TARGETS).embeddings
        want = online.infer(TARGETS).embeddings
        rep = hybrid.precompute_report()
    np.testing.assert_allclose(want, got, rtol=RTOL, atol=ATOL)
    assert rep["hits"] > 0 and rep["misses"] > 0


def test_all_fresh_plan_short_circuits_pipeline():
    g = _graph()
    cfg = _cfg("sgc")
    with DecoupledEngine(g, cfg, config=_sc(
            precompute=PrecomputeConfig())) as eng:
        plan = eng.plan(np.arange(C))
        assert plan.tier_done
        assert plan.tier_rows is not None and plan.tier_fresh.all()
        assert plan.node_lists is None and plan.rows is None \
            and plan.device is None
        out = eng.run_device(plan).numpy()
        np.testing.assert_array_equal(out, plan.tier_rows)


def test_budget_bytes_caps_residency():
    g = _graph(seed=6)
    cfg = _cfg("sgc")
    params = init_gnn(cfg, 0, device="cpu")
    budget = 16 * 32 * 4                   # room for 16 of 64 rows
    with DecoupledEngine(g, cfg, params=params, config=_sc(
            precompute=PrecomputeConfig(budget_bytes=budget))) as eng, \
            DecoupledEngine(g, cfg, params=params,
                            config=_sc()) as online:
        rep = eng.precompute_report()
        assert rep["resident"] == 16 and rep["tier_bytes"] <= budget
        np.testing.assert_allclose(online.infer(TARGETS).embeddings,
                                   eng.infer(TARGETS).embeddings,
                                   rtol=RTOL, atol=ATOL)
        assert eng.precompute_report()["misses"] > 0


def test_models_filter_and_unsupported_kind():
    g = _graph()
    with DecoupledEngine(g, _cfg("sgc"), config=_sc(
            precompute=PrecomputeConfig(models=("appnp",)))) as eng:
        assert eng.precompute is None
        assert eng.precompute_report() == {"enabled": False}
    gat = GNNConfig(kind="gat", n_layers=2, receptive_field=V,
                    f_in=SPEC.feature_dim, f_hidden=32, readout="target")
    with pytest.raises(PrecomputeError, match="not precomputable"):
        DecoupledEngine(g, gat, config=_sc(
            precompute=PrecomputeConfig()))
    maxout = GNNConfig(kind="sgc", n_layers=2, receptive_field=V,
                       f_in=SPEC.feature_dim, f_hidden=32, readout="max")
    with pytest.raises(PrecomputeError, match="readout"):
        DecoupledEngine(g, maxout, config=_sc(
            precompute=PrecomputeConfig()))


def test_artifact_roundtrip_and_stale_rejection(tmp_path):
    from repro_torch.graphs.synthetic import get_graph
    from repro_torch.precompute import build

    out = str(tmp_path / "tier")
    rc = build.main(["--dataset", "flickr", "--scale", "0.001",
                     "--kind", "sgc", "--layers", "2", "--hidden", "32",
                     "--rf", "32", "--impl", "torch", "--device", "cpu",
                     "--out", out])
    assert rc == 0
    g = get_graph("flickr", scale=0.001, seed=0)
    cfg = GNNConfig(kind="sgc", n_layers=2, receptive_field=32,
                    f_in=g.feature_dim, f_hidden=32, readout="target")
    art = _sc(precompute=PrecomputeConfig(artifact=out))
    t = np.arange(16)
    with DecoupledEngine(g, cfg, config=art) as loaded, \
            DecoupledEngine(g, cfg, config=_sc(
                precompute=PrecomputeConfig())) as built:
        assert loaded.precompute_report()["builds"] == 0
        assert built.precompute_report()["builds"] == 1
        np.testing.assert_array_equal(loaded.infer(t).embeddings,
                                      built.infer(t).embeddings)
    g2 = make_graph(SPEC, seed=0)
    cfg2 = GNNConfig(kind="sgc", n_layers=2, receptive_field=32,
                     f_in=SPEC.feature_dim, f_hidden=32, readout="target")
    with pytest.raises(PrecomputeArtifactError, match="rebuild"):
        DecoupledEngine(g2, cfg2, config=art)


def test_tier_lookup_and_epoch_guard():
    tier = EmbeddingTier(8, 4)
    rows = np.arange(32, dtype=np.float32).reshape(8, 4)
    tier.install(np.arange(8), rows)
    got, fresh = tier.lookup(np.array([1, 5]))
    assert fresh.all()
    np.testing.assert_array_equal(got, rows[[1, 5]])
    epochs = tier.epoch_of(np.array([2, 3]))
    tier.demote(np.array([3]))
    tier.promote(np.array([2, 3]), np.zeros((2, 4), np.float32), epochs)
    _, fresh = tier.lookup(np.array([2, 3]))
    assert fresh[0] and not fresh[1]


def test_calibration_lookup_and_measured_specialize():
    from repro_torch.obs.calib import CalibrationTable

    t = CalibrationTable()
    assert t.lookup("Aggregate", "torch/dense") is None
    for _ in range(8):
        t.record("Aggregate", "torch/dense", 5, 4e-3)
        t.record("Aggregate", "torch/sg", 5, 1e-3)
    assert t.lookup("Aggregate", "torch/sg", 5) < \
        t.lookup("Aggregate", "torch/dense", 5)
    assert t.lookup("Aggregate", "torch/sg") is not None   # best bucket
    cfg = GNNConfig(kind="gcn", n_layers=2, receptive_field=16,
                    f_in=8, f_hidden=16)
    _, dec = specialize(lower(cfg), n=16, avg_edges=4.0, f_in=8,
                        f_hidden=16, measured=t, measured_bucket=5)
    agg = [d for d in dec if d.mux]
    assert agg and all(d.mode == "sg" for d in agg)
    assert all("measured" in d.reason for d in agg)
    _, dec = specialize(lower(cfg), n=16, avg_edges=4.0, f_in=8,
                        f_hidden=16, measured=t, measured_bucket=5,
                        force="dense")
    assert all(d.mode == "dense" for d in dec if d.mux)
    _, dec = specialize(lower(cfg), n=16, avg_edges=4.0, f_in=8,
                        f_hidden=16, measured=t, measured_bucket=9)
    assert all("measured" not in d.reason for d in dec if d.mux)


def test_report_schema_section():
    assert SCHEMA_VERSION >= 3    # precompute.* landed in v3
    g = _graph()
    with DecoupledEngine(g, _cfg("sgc"), config=_sc(
            precompute=PrecomputeConfig())) as eng:
        eng.infer(np.arange(C))
        rep = eng.precompute_report()
    assert rep["enabled"] is True
    assert set(rep) <= set(SCHEMA["precompute"])


def test_precompute_config_validation():
    with pytest.raises(ValueError):
        PrecomputeConfig(chunk_size=0)
    with pytest.raises(ValueError):
        PrecomputeConfig(refresh_workers=0)
    with pytest.raises(ValueError):
        PrecomputeConfig(budget_bytes=-1)
    with pytest.raises(TypeError, match="PrecomputeConfig"):
        _sc(precompute=42)
    d = _sc(precompute=PrecomputeConfig()).describe()
    assert "precompute" in d


# -- the server's precompute section -----------------------------------------


def test_server_report_has_precompute_section():
    from repro_torch.serve.gnn_server import GNNServer
    g = _graph()
    with DecoupledEngine(g, _cfg("sgc"), config=_sc(
            batch_size=4, precompute=PrecomputeConfig())) as eng:
        srv = GNNServer(eng, max_wait_s=0.005)
        srv.start()
        reqs = [srv.submit(int(t)) for t in [0, 1, 2, 3, 4, 5, 6, 7]]
        srv.drain(reqs, timeout=120)
        srv.stop()
        m = srv.report()["models"]["default"]
        assert m["precompute"]["hits"] == 8
        assert set(m["precompute"]) <= set(SCHEMA["precompute"])
        want = eng.precompute.tier.lookup(np.arange(8))[0]
        np.testing.assert_array_equal(
            np.stack([r.embedding for r in reqs]), want)


# -- the port against the reference -------------------------------------------


def _pair(kind, n_layers, seed=0):
    """The same graph in both packages, the same cfg, the reference's
    params and the port's copy of them."""
    jg, tg = j_make_graph(J_SPEC, seed=seed), make_graph(SPEC, seed=seed)
    kw = dict(kind=kind, n_layers=n_layers, receptive_field=V,
              f_in=SPEC.feature_dim, f_hidden=32, ppr_eps=1e-9,
              readout="target")
    jp = j_init(JGNN(**kw), jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jprog, _ = j_specialize(j_lower(JGNN(**kw)), n=V,
                            f_in=SPEC.feature_dim, f_hidden=32)
    tprog, _ = specialize(lower(GNNConfig(**kw)), n=V,
                          f_in=SPEC.feature_dim, f_hidden=32)
    return jg, tg, jp, tp, jprog, tprog


@pytest.mark.parametrize("with_out_ids", [False, True])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("kind,n_layers", [("sgc", 2), ("appnp", 3),
                                           ("gcn", 2), ("gcn", 3),
                                           ("sage", 3)])
def test_layer_major_matches_reference(kind, n_layers, impl, with_out_ids):
    jg, tg, jp, tp, jprog, tprog = _pair(kind, n_layers)
    out_ids = np.array([0, 5, 17, 33, 63]) if with_out_ids else None
    # chunk 24: three chunks over 64 vertices, the last one ragged
    want = j_prop.layer_major_embeddings(jg, jprog, jp, chunk_size=24,
                                         out_ids=out_ids)
    got = layer_major_embeddings(tg, tprog, tp, chunk_size=24,
                                 out_ids=out_ids, impl=impl, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,n_layers", [("sgc", 2), ("appnp", 3),
                                           ("gcn", 3), ("sage", 2)])
def test_hops_and_closure_equal_reference(kind, n_layers):
    jg, tg, _, _, jprog, tprog = _pair(kind, n_layers, seed=3)
    assert agg_hops(tprog) == j_prop.agg_hops(jprog)
    hops = agg_hops(tprog)
    for out_ids in ([11], [0, 7, 40], np.arange(0, V, 9)):
        np.testing.assert_array_equal(
            dependency_closure(tg, np.asarray(out_ids), hops),
            j_prop.dependency_closure(jg, np.asarray(out_ids), hops))


def test_tier_bookkeeping_equals_reference():
    rng = np.random.default_rng(0)
    deg = rng.integers(1, 20, 40)
    jt = JTier(40, 6, budget_bytes=24 * 6 * 4, degrees=deg)
    tt = EmbeddingTier(40, 6, budget_bytes=24 * 6 * 4, degrees=deg)
    np.testing.assert_array_equal(tt.resident_ids, jt.resident_ids)
    rows = rng.standard_normal((40, 6)).astype(np.float32)
    for t in (jt, tt):
        t.install(np.arange(40), rows)
    q = rng.integers(0, 40, 30)
    for a, b in zip(tt.lookup(q), jt.lookup(q)):
        np.testing.assert_array_equal(a, b)
    d = rng.integers(0, 40, 9)
    np.testing.assert_array_equal(tt.demote(d), jt.demote(d))
    ids = np.arange(0, 40, 3)
    ep_t, ep_j = tt.epoch_of(ids), jt.epoch_of(ids)
    np.testing.assert_array_equal(ep_t, ep_j)
    tt.demote(ids[:2])
    jt.demote(ids[:2])
    new = rng.standard_normal((len(ids), 6)).astype(np.float32)
    assert tt.promote(ids, new, ep_t) == jt.promote(ids, new, ep_j)
    for a, b in zip(tt.lookup(np.arange(40)), jt.lookup(np.arange(40))):
        np.testing.assert_array_equal(a, b)
    assert tt.stats() == jt.stats()


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("norm", ["gcn", "mean"])
def test_chunk_form_equals_reference_chunk(impl, norm):
    """One chunk's Aggregate in the compact form (its distinct sources
    gathered, sources renumbered, N = max(chunk, sources)) against the
    reference's chunk function on the full register, with a non-finite
    row 0 so the padding edges' 0 * h[0] shows."""
    jg, tg, *_ = _pair("gcn", 2)
    ids = np.arange(V, dtype=np.int64)
    local = _LocalCSR(tg, ids, 16, impl, torch.device("cpu"))
    rng = np.random.default_rng(1)
    H = rng.standard_normal((V, 12)).astype(np.float32)
    H[0, 3] = np.inf
    c = 1
    c0, (e0, e1) = local.starts[c], local.e_ranges[c]
    e = e1 - e0
    assert e < local.e_cap                 # the chunk has padding edges
    src = np.zeros(local.e_cap, np.int32)
    rel = np.zeros(local.e_cap, np.int32)
    w = np.zeros(local.e_cap, np.float32)
    src[:e] = local.src[e0:e1]
    rel[:e] = (local.dst[e0:e1] - c0).astype(np.int32)
    w[:e] = local._w[norm][e0:e1]
    want = np.asarray(j_prop._agg_chunk_fn(16)(src, rel, w, H))
    rows, csrc, cdst, nrows = compact_chunk(src[:e], rel[:e], local.e_cap,
                                            16)
    assert nrows == max(16, len(rows)) and rows[0] == 0
    h = np.zeros((nrows, 12), np.float32)
    h[:len(rows)] = H[rows]
    got = chunk_aggregate(torch.from_numpy(csrc)[None],
                          torch.from_numpy(cdst)[None],
                          torch.from_numpy(w)[None],
                          torch.from_numpy(h)[None], impl)[0, :16].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 3])             # 0 * inf on destination 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the engine's own path: the compact forms of every chunk
    full = local.aggregate(norm, torch.from_numpy(H)).numpy()
    z = np.asarray(j_prop._LocalCSR(jg, ids, 16).aggregate(norm, H))
    np.testing.assert_array_equal(np.isnan(full), np.isnan(z))
    np.testing.assert_allclose(full, z, rtol=RTOL, atol=ATOL)


def test_reference_artifact_serves_reference_rows(tmp_path):
    """An artifact the reference wrote loads in the port when the
    deployment is the same: the stamps hash the same bytes (graph, model
    signature, params through params_from_jax), and the port serves the
    reference's rows bitwise."""
    jg, tg, jp, tp, jprog, _ = _pair("sgc", 2)
    emb = j_prop.layer_major_embeddings(jg, jprog, jp)
    out = str(tmp_path / "ref_tier")
    kw = dict(kind="sgc", n_layers=2, receptive_field=V,
              f_in=SPEC.feature_dim, f_hidden=32, ppr_eps=1e-9,
              readout="target")
    j_save_artifact(out, emb, jg, JGNN(**kw), jp)
    with DecoupledEngine(tg, GNNConfig(**kw), params=tp, config=_sc(
            precompute=PrecomputeConfig(artifact=out))) as eng:
        assert eng.precompute_report()["builds"] == 0
        got = eng.infer(TARGETS).embeddings
    np.testing.assert_array_equal(got, emb[TARGETS])
    # other params: refused with the mismatch error
    other = init_gnn(GNNConfig(**kw), 7, device="cpu")
    with pytest.raises(PrecomputeArtifactError, match="params_fingerprint"):
        DecoupledEngine(tg, GNNConfig(**kw), params=other, config=_sc(
            precompute=PrecomputeConfig(artifact=out)))


def test_port_artifact_roundtrip(tmp_path):
    from repro_torch.precompute.artifact import load_artifact, save_artifact
    _, tg, _, tp, _, tprog = _pair("gcn", 2)
    cfg = GNNConfig(kind="gcn", n_layers=2, receptive_field=V,
                    f_in=SPEC.feature_dim, f_hidden=32, ppr_eps=1e-9,
                    readout="target")
    emb = layer_major_embeddings(tg, tprog, tp, device="cpu")
    out = save_artifact(str(tmp_path / "t"), emb, tg, cfg, tp)
    np.testing.assert_array_equal(load_artifact(out, tg, cfg, tp), emb)


class TestPlanes:
    def test_precompute_and_sharded_no_longer_raise(self):
        sc = ServingConfig(device="cpu", precompute=PrecomputeConfig(),
                           store=StorePolicy(features="sharded",
                                             num_shards=2))
        assert sc.describe()["precompute"] == PrecomputeConfig().describe()

    @pytest.mark.parametrize("mode", ["dense", "sg"])
    def test_tiered_engine_behind_inproc_is_bitwise_local(self, mode):
        """Both planes at once: a tiered engine whose Select/Build run
        behind the loopback transport serves the bits of the local tiered
        engine, on a mixed batch (the online half crosses the wire) and
        on all-fresh ones (no remote call)."""
        g = _graph(seed=2)
        cfg = _cfg("gcn")
        params = init_gnn(cfg, 0, device="cpu")
        pconf = PrecomputeConfig(auto_refresh=False)
        outs = {}
        for transport in ("local", "inproc"):
            with DecoupledEngine(g, cfg, params=params, config=_sc(
                    mode=mode, transport=transport,
                    precompute=pconf)) as eng:
                fresh = eng.infer(TARGETS).embeddings
                eng.precompute.on_invalidate([3])
                mixed = eng.infer(TARGETS).embeddings
                outs[transport] = (fresh, mixed,
                                   eng.scheduler.stats.rpc_calls)
        for a, b in zip(outs["local"][:2], outs["inproc"][:2]):
            np.testing.assert_array_equal(a, b)
        assert outs["local"][2] == 0 and outs["inproc"][2] > 0

    def test_metered_tiered_engine_exposes_tier_counters(self):
        from repro_torch.obs import TelemetryConfig, validate_exposition
        g = _graph(seed=2)
        cfg = _cfg("gcn")
        with DecoupledEngine(g, cfg, config=_sc(
                precompute=PrecomputeConfig(auto_refresh=False),
                telemetry=TelemetryConfig())) as eng:
            eng.infer(TARGETS)
            eng.precompute.on_invalidate([3])
            eng.infer(TARGETS)
            rep = eng.telemetry_report()
            text = eng.metrics_text()
            tier = eng.precompute_report()
        assert rep["counters"]["repro_tier_hits_total"] == tier["hits"] > 0
        assert rep["counters"]["repro_tier_demotions_total"] \
            == tier["demotions"] > 0
        assert "repro_tier_hits_total" in text
        assert validate_exposition(text) == []

    def test_sharded_tiered_engine_serves(self):
        """Both planes at once: a tiered engine over the sharded store."""
        g = _graph(seed=2)
        cfg = _cfg("gcn")
        params = init_gnn(cfg, 0, device="cpu")
        with DecoupledEngine(g, cfg, params=params, config=_sc(
                store=StorePolicy(features="sharded", num_shards=2),
                precompute=PrecomputeConfig(auto_refresh=False))) as eng, \
                DecoupledEngine(g, cfg, params=params,
                                config=_sc()) as online:
            eng.precompute.on_invalidate([3])
            got = eng.infer(TARGETS).embeddings
            want = online.infer(TARGETS).embeddings
            assert eng.scheduler.stats.shard_bytes
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
