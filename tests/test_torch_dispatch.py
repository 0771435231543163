"""The PyTorch package's per-batch adaptive dispatch against the
reference's: the variant cache, the warm-up schedule and the policy's
decisions from the same table (cells named ``cuda``/``torch`` for the
reference's ``pallas``/``xla``), the bitwise contract within the port (an
adaptive engine serves the bits of the engine forced to the mode vector it
chose), the kernels' block autotune, calibration persistence (the
checkpoint layout read by both packages), and an adaptive engine of each
package taking the same decisions on the same graph, params and table with
embeddings within tests/test_torch_program.py's tolerance. (The
reference's ``test_dispatch_metrics_exposed`` has its counterpart in
tests/test_torch_telemetry.py.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.core import program as jprog  # noqa: E402
from repro.core.config import ServingConfig as JConfig  # noqa: E402
from repro.core.dispatch import DispatchConfig as JDispatchConfig  # noqa: E402
from repro.core.dispatch import DispatchPolicy as JPolicy  # noqa: E402
from repro.core.engine import DecoupledEngine as JEngine  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN, init_gnn as j_init  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro.obs.calib import CalibrationTable as JTable  # noqa: E402
from repro.obs.calib import WarmupSchedule as JWarmup  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core import program as tprog  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.dispatch import (DispatchConfig,  # noqa: E402
                                       DispatchPolicy, VariantCache,
                                       variant_key)
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.report_schema import SCHEMA  # noqa: E402
from repro_torch.core.subgraph import build_batch  # noqa: E402
from repro_torch.gnn.model import (GNNConfig, init_gnn,  # noqa: E402
                                   params_from_jax)
from repro_torch.graphs.csr import from_edge_list  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.kernels.fused_gnn import BLOCK_F_CANDIDATES  # noqa: E402
from repro_torch.kernels.scatter_gather import \
    BLOCK_COLS_CANDIDATES  # noqa: E402
from repro_torch.obs.calib import (CalibrationArtifactError,  # noqa: E402
                                   CalibrationTable, WarmupSchedule,
                                   best_block, load_calibration, op_label,
                                   op_mode, run_block_autotune,
                                   save_calibration, size_bucket)

KINDS = ("gcn", "sage", "gin", "gat")
N = 16
BUCKET = int(2 * N).bit_length()          # C*N of the C=2 engines
RTOL, ATOL = 1e-4, 1e-5                   # tests/test_torch_program.py's


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=0.005, seed=1)   # ~450 vertices


def sparse_graph(v=512, edges=48, f=64, seed=0):
    """Mean degree << 1: the regime where sg aggregation wins."""
    rng = np.random.default_rng(seed)
    src = rng.choice(v, edges, replace=False)
    dst = (src + 1 + rng.integers(0, v - 1, edges)) % v
    feats = rng.standard_normal((v, f)).astype(np.float32)
    return from_edge_list(src, dst, v, feats, name="ultra-sparse")


def make_cfg(g, kind="gcn"):
    return GNNConfig(kind=kind, n_layers=2, receptive_field=N,
                     f_in=g.feature_dim, f_hidden=128)


def conf(**kw):
    kw.setdefault("mode", "auto")
    return ServingConfig(device="cpu", batch_size=2, **kw)


def serve(g, cfg, params, config, targets):
    with DecoupledEngine(g, cfg, params=params, config=config) as eng:
        out = eng.infer(targets).embeddings
        rep = eng.dispatch_report()
    return out, rep


def inject(table, program, impl, sec_costs, bucket=BUCKET):
    """Record ``cost`` for every step of each section compiled all-``mode``
    (``sec_costs``: {mode: cost}), as a warm-up pass would."""
    sites = tprog.mux_sites(program)
    for sec, _ in program.layer_sections():
        sec_sites = [s for s in sites if s.startswith(sec)]
        for mode, cost in sec_costs.items():
            seq = getattr(tprog.respecialize(
                program, {s: mode for s in sec_sites}), sec)
            for ops, _ in tprog.compile_steps(seq, impl):
                table.record(op_label(ops), op_mode(ops, impl), bucket,
                             cost)


# ---------------------------------------------------------------------------


class TestVariantCache:
    def test_bounded_lru_with_counters(self):
        vc = VariantCache(capacity=2)
        fns = {}
        for k in ("a", "b", "c"):
            fns[k] = vc.get(k, lambda k=k: (lambda: k))
        assert len(vc) == 2
        assert (vc.evictions, vc.misses, vc.hits) == (1, 3, 0)
        assert "a" not in vc.keys()               # LRU order: a evicted
        assert fns["a"]() == "a"                  # holder still runs it
        assert vc.get("b", lambda: None)() == "b"
        assert vc.hits == 1
        vc.get("b", lambda: "B")
        vc.get("d", lambda: "D")                  # c is LRU now
        assert set(vc.keys()) == {"b", "d"}

    def test_validation_and_key(self):
        with pytest.raises(ValueError):
            VariantCache(capacity=0)
        with pytest.raises(ValueError):
            DispatchConfig(variant_capacity=0)
        with pytest.raises(ValueError):
            DispatchConfig(warmup_passes=-1)
        with pytest.raises(TypeError, match="DispatchConfig"):
            ServingConfig(device="cpu", dispatch=object())
        assert variant_key({"x": "sg", "y": "dense"}, {"block_f": 128}) \
            == variant_key({"y": "dense", "x": "sg"}, {"block_f": 128})
        assert variant_key({}, {"block_cols": None}) == variant_key({}, {})
        assert DispatchConfig().describe() == JDispatchConfig().describe()


class TestWarmupSchedule:
    @pytest.mark.parametrize("seed", [0, 7, 11])
    def test_same_schedule_as_reference(self, seed):
        mine, ref = WarmupSchedule(passes=2, seed=seed), \
            JWarmup(passes=2, seed=seed)
        for bucket in (5, 9, 13, 5, 9):
            seq = [mine.next_mode(bucket) for _ in range(3)]
            assert seq == [ref.next_mode(bucket) for _ in range(3)]
        assert mine.history == ref.history
        assert mine.state() == ref.state()
        assert None in seq                        # exhausted at 2*passes


def _policies(graph, kind, costs):
    """The port's and the reference's policies over the same program with
    the same injected p50s (``costs``: {(section, mode): seconds})."""
    jcfg = JGNN(kind=kind, n_layers=2, receptive_field=N,
                f_in=graph.feature_dim, f_hidden=128)
    jp, _ = jprog.lower_and_specialize(jcfg)
    tp, _ = tprog.lower_and_specialize(make_cfg(graph, kind))
    pols = []
    for prog, mod, impl, table, cls in (
            (tp, tprog, "cuda", CalibrationTable(), DispatchPolicy),
            (jp, jprog, "pallas", JTable(), JPolicy)):
        sites = mod.mux_sites(prog)
        for (sec, mode), cost in costs.items():
            seq = getattr(mod.respecialize(prog, {
                s: mode for s in sites if s.startswith(sec)}), sec)
            for ops, _ in mod.compile_steps(seq, impl):
                label = "+".join(type(o).__name__ for o in ops)
                table.record(label, f"{impl}/{mode}", BUCKET, cost)
        pols.append(cls(prog, impl, table, n=N, f_in=graph.feature_dim,
                        f_hidden=128, warmup_passes=1, seed=3,
                        autotune_blocks=False))
    return pols


class TestDecide:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("costs", [
        {("layer0", "dense"): 1e-3, ("layer0", "sg"): 2e-3,
         ("inner", "dense"): 3e-3, ("inner", "sg"): 1e-3},
        {("layer0", "sg"): 1e-3},                 # partly cold
        {}])                                      # all cold: FLOP + warm-up
    def test_same_decision_as_reference(self, graph, kind, costs):
        mine, ref = _policies(graph, kind, costs)
        for avg_edges in (3.0, 40.0, 3.0):
            a, b = mine.decide(avg_edges, BUCKET), ref.decide(avg_edges,
                                                              BUCKET)
            assert (a.assignment, a.site_sources, a.source, a.warm_mode) \
                == (b.assignment, b.site_sources, b.source, b.warm_mode)
        assert mine.report()["sources"] == ref.report()["sources"]


# ---------------------------------------------------------------------------
# the bitwise contract within the port


class TestAdaptiveBitwise:
    @pytest.mark.parametrize("impl", ("torch", "cuda"))
    @pytest.mark.parametrize("kind", KINDS)
    def test_auto_equals_matching_forced(self, graph, kind, impl):
        """Auto on the hub-dense regime serves the forced engine's bits for
        the mode it picks, warm-up passes in the loop; on the CPU the
        cuda impl runs its kernels' plain versions."""
        cfg = make_cfg(graph, kind)
        params = init_gnn(cfg, 3, device="cpu")
        targets = np.arange(4)
        dc = DispatchConfig(warmup_passes=1, autotune_blocks=False)
        auto, rep = serve(graph, cfg, params, conf(impl=impl, dispatch=dc),
                          targets)
        assert rep["decisions"] == 2 and rep["explore_failures"] == 0
        forced, _ = serve(graph, cfg, params, conf(impl=impl, mode="dense"),
                          targets)
        np.testing.assert_array_equal(auto, forced)

    @pytest.mark.parametrize("impl", ("torch", "cuda"))
    @pytest.mark.parametrize("kind", ("gcn", "sage"))
    def test_auto_equals_forced_sg_on_sparse(self, kind, impl):
        g = sparse_graph()
        cfg = make_cfg(g, kind)
        params = init_gnn(cfg, 3, device="cpu")
        dc = DispatchConfig(warmup_passes=1, autotune_blocks=True)
        auto, rep = serve(g, cfg, params, conf(impl=impl, dispatch=dc),
                          np.arange(4))
        forced, _ = serve(g, cfg, params, conf(impl=impl, mode="sg"),
                          np.arange(4))
        np.testing.assert_array_equal(auto, forced)
        assert rep["explore_failures"] == 0


class TestMeasuredDispatch:
    @pytest.mark.parametrize("impl", ("torch", "cuda"))
    def test_injected_table_forces_sg_bitwise(self, graph, impl):
        """A table whose cells make sg cheaper flips serving to all-sg from
        the FIRST batch (no warm-up), bitwise equal to the forced sg
        engine."""
        cfg = make_cfg(graph)
        params = init_gnn(cfg, 3, device="cpu")
        dc = DispatchConfig(warmup_passes=0, autotune_blocks=False)
        with DecoupledEngine(graph, cfg, params=params, config=conf(
                impl=impl, dispatch=dc)) as eng:
            inject(eng.dispatch.table, eng.program, impl,
                   {"dense": 1.0, "sg": 1e-6})
            auto = eng.infer(np.arange(4)).embeddings
            rep = eng.dispatch_report()
        assert rep["sources"]["measured"] == rep["decisions"] > 0
        assert rep["sources"]["warmup"] == 0
        assert set(rep) <= set(SCHEMA["dispatch"])
        assert rep["variants"]["size"] <= rep["variants"]["capacity"]
        forced, _ = serve(graph, cfg, params, conf(impl=impl, mode="sg"),
                          np.arange(4))
        np.testing.assert_array_equal(auto, forced)

    def test_warmup_then_exploit_deterministic(self, graph):
        cfg = make_cfg(graph)
        params = init_gnn(cfg, 3, device="cpu")
        dc = DispatchConfig(warmup_passes=1, seed=11, autotune_blocks=False)
        histories = []
        for _ in range(2):
            with DecoupledEngine(graph, cfg, params=params,
                                 config=conf(dispatch=dc)) as eng:
                eng.infer(np.arange(8))           # 4 batches
                rep = eng.dispatch_report()
                histories.append(list(eng.dispatch.warmup.history))
        assert histories[0] == histories[1]
        ref = JWarmup(passes=1, seed=11)
        assert histories[0] == [(BUCKET, ref.next_mode(BUCKET))
                                for _ in range(2)]
        assert (rep["sources"]["warmup"], rep["sources"]["measured"],
                rep["sources"]["flop"]) == (2, 2, 0)
        assert rep["warmup"]["done"] == {BUCKET: 2}

    def test_forced_mode_keeps_policy_inert(self, graph):
        with DecoupledEngine(graph, make_cfg(graph), config=conf(
                mode="sg", dispatch=DispatchConfig())) as eng:
            eng.infer(np.arange(4))
            rep = eng.dispatch_report()
            assert eng.dispatch is None
        assert rep["policy"] == "forced"
        assert rep["sources"] == {"forced": 2}


# ---------------------------------------------------------------------------
# kernel block autotune


class TestBlockAutotune:
    def test_best_block_requires_full_grid(self):
        t = CalibrationTable()
        cands = (64, 128, 256)
        assert best_block(t, "fused_gnn", "bf=", cands, 7) is None
        t.record("fused_gnn", "cuda/bf=64", 7, 2e-3)
        t.record("fused_gnn", "cuda/bf=128", 7, 1e-3)
        t.record("fused_gnn", "cuda/bf=256", 8, 9e-4)
        assert best_block(t, "fused_gnn", "bf=", cands, 7) == 128
        assert best_block(t, "fused_gnn", "bf=", cands, 8) == 256
        t.record("fused_gnn", "cuda/bf=256", 7, 5e-4)
        assert best_block(t, "fused_gnn", "bf=", cands, 7) == 256

    def test_autotune_records_cells_and_policy_consumes(self, graph):
        """run_block_autotune records a cell for every legal candidate
        (through the plain versions on the CPU); the policy's block
        overrides appear once the grid is complete, and a variant served
        with them gives the default's bits."""
        cfg = make_cfg(graph)
        params = init_gnn(cfg, 0, device="cpu")
        prog, _ = tprog.lower_and_specialize(cfg, force="dense")
        sb = build_batch(graph, [1, 2], N, e_pad=N * (N - 1),
                         num_threads=1)
        with DecoupledEngine(graph, cfg, params=params,
                             config=conf(mode="sg", impl="torch")) as eng:
            batch = eng.device_batch(sb)        # features f_in wide
        batch.setdefault("adj", sb.adj)
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 batch.items()}
        table = CalibrationTable()
        run_block_autotune(prog, params, batch, table)
        bucket = size_bucket(batch)
        fout = params["layer0"]["w"].shape[1]
        legal_bf = [b for b in BLOCK_F_CANDIDATES
                    if b <= fout and fout % b == 0]
        for b in legal_bf:
            assert table.lookup("fused_gnn", f"cuda/bf={b}", bucket)
        for b in BLOCK_COLS_CANDIDATES:
            assert table.lookup("scatter_gather", f"cuda/bc={b}", bucket)
        pol = DispatchPolicy(prog, "cuda", table, n=N, f_in=cfg.f_in,
                             f_hidden=cfg.f_hidden)
        blocks = pol._blocks(bucket)
        assert blocks.get("block_f") in legal_bf
        assert blocks.get("block_cols") in BLOCK_COLS_CANDIDATES
        assert DispatchPolicy(prog, "torch", table, n=N, f_in=cfg.f_in,
                              f_hidden=cfg.f_hidden)._blocks(bucket) == {}
        sg = tprog.respecialize(prog, {s: "sg" for s in
                                       tprog.mux_sites(prog)})
        want, _ = tprog.execute(sg, params, batch, impl="cuda")
        got, _ = tprog.execute(sg, params, batch, impl="cuda",
                               blocks=blocks)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# persistence


class TestPersistence:
    def _table(self):
        t = CalibrationTable()
        for v in (1e-4, 2e-4, 3e-4, 5e-3):
            t.record("Aggregate", "torch/dense", 7, v)
            t.record("Aggregate", "torch/sg", 7, v * 0.1)
        t.passes = 4
        return t

    def test_roundtrip_is_lossless(self, graph, tmp_path):
        cfg = make_cfg(graph)
        t = self._table()
        path = str(tmp_path / "calib")
        save_calibration(path, t, graph=graph, cfg=cfg, impl="torch")
        t2 = load_calibration(path, graph=graph, cfg=cfg, impl="torch")
        assert t2.passes == t.passes and len(t2) == len(t)
        for mode in ("torch/dense", "torch/sg"):
            assert t2.lookup("Aggregate", mode, 7) == \
                t.lookup("Aggregate", mode, 7)

    def test_stale_artifact_refuses(self, graph, tmp_path):
        cfg = make_cfg(graph)
        path = str(tmp_path / "calib")
        save_calibration(path, self._table(), graph=graph, cfg=cfg,
                         impl="torch")
        other = GNNConfig(kind="gcn", n_layers=2, receptive_field=N,
                          f_in=graph.feature_dim, f_hidden=256)
        with pytest.raises(CalibrationArtifactError, match="rebuild"):
            load_calibration(path, graph=graph, cfg=other, impl="torch")
        with pytest.raises(CalibrationArtifactError, match="impl|model"):
            load_calibration(path, graph=graph, cfg=cfg, impl="cuda")
        g2 = sparse_graph()
        with pytest.raises(CalibrationArtifactError,
                           match="graph_fingerprint"):
            load_calibration(path, graph=g2, cfg=make_cfg(g2), impl="torch")

    def test_engine_saves_on_close_and_restarts_warm(self, graph, tmp_path):
        cfg = make_cfg(graph)
        params = init_gnn(cfg, 3, device="cpu")
        path = str(tmp_path / "calib")
        sconf = conf(dispatch=DispatchConfig(
            warmup_passes=1, autotune_blocks=False, artifact=path))
        with DecoupledEngine(graph, cfg, params=params, config=sconf) as eng:
            eng.infer(np.arange(8))
            cells = len(eng._calib)
        assert ckpt.committed_steps(path) and cells > 0
        with DecoupledEngine(graph, cfg, params=params, config=sconf) as eng:
            assert len(eng._calib) == cells
            eng.infer(np.arange(4))
            rep = eng.dispatch_report()
        assert rep["sources"] == {"measured": 2, "flop": 0, "warmup": 0,
                                  "forced": 0}

    def test_checkpoints_cross_both_packages(self, tmp_path):
        rng = np.random.default_rng(0)
        tree = {"b": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                      "i": np.arange(5, dtype=np.int64)},
                "a": [rng.standard_normal(2).astype(np.float32),
                      np.float32(1.5)]}
        like = {"b": {"w": torch.zeros(3, 4), "i": np.zeros(5, np.int64)},
                "a": [np.zeros(2, np.float32), np.float32(0)]}
        ckpt.save(str(tmp_path / "port"), 3, {
            "b": {"w": torch.from_numpy(tree["b"]["w"]),
                  "i": tree["b"]["i"]}, "a": tree["a"]}, extra={"k": 1})
        got, step, extra = j_ckpt.restore(str(tmp_path / "port"), tree)
        assert (step, extra) == (3, {"k": 1})
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        j_ckpt.save(str(tmp_path / "ref"), 5, tree, extra={"k": 2})
        got, step, extra = ckpt.restore(str(tmp_path / "ref"), like)
        assert (step, extra) == (5, {"k": 2})
        assert isinstance(got["b"]["w"], torch.Tensor)
        assert torch.equal(got["b"]["w"], torch.from_numpy(tree["b"]["w"]))
        assert np.array_equal(got["b"]["i"], tree["b"]["i"])
        assert np.array_equal(got["a"][0], tree["a"][0])
        bf = {"x": torch.randn(4, dtype=torch.float32).bfloat16()}
        ckpt.save(str(tmp_path / "bf"), 0, bf)
        back, _, _ = ckpt.restore(str(tmp_path / "bf"),
                                  {"x": torch.zeros(4, dtype=torch.bfloat16)})
        assert torch.equal(back["x"], bf["x"])


# ---------------------------------------------------------------------------
# end to end against the reference


def test_adaptive_engines_agree_with_reference():
    """The same graph, params (params_from_jax) and injected table: both
    adaptive engines take the same decisions, and their embeddings agree
    at tests/test_torch_program.py's tolerance."""
    jg = j_get_graph("flickr", scale=0.005, seed=1)
    g = get_graph("flickr", scale=0.005, seed=1)
    jcfg = JGNN(kind="gcn", n_layers=2, receptive_field=N,
                f_in=jg.feature_dim, f_hidden=128)
    jp = j_init(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    targets = np.arange(6)
    costs = {"dense": 1.0, "sg": 1e-6}
    with JEngine(jg, jcfg, params=jp, config=JConfig(
            batch_size=2, mode="auto", impl="xla", dispatch=JDispatchConfig(
                warmup_passes=0, autotune_blocks=False))) as je:
        sites = jprog.mux_sites(je.program)
        for sec, _ in je.program.layer_sections():
            for mode, cost in costs.items():
                seq = getattr(jprog.respecialize(je.program, {
                    s: mode for s in sites if s.startswith(sec)}), sec)
                for ops, _ in jprog.compile_steps(seq, "xla"):
                    je.dispatch.table.record(
                        "+".join(type(o).__name__ for o in ops),
                        f"xla/{mode}", BUCKET, cost)
        want = je.infer(targets).embeddings
        jrep = je.dispatch_report()
        jdec = je.dispatch._measured_assignment(BUCKET)
    with DecoupledEngine(g, make_cfg(g), params=tp, config=conf(
            impl="torch", dispatch=DispatchConfig(
                warmup_passes=0, autotune_blocks=False))) as te:
        inject(te.dispatch.table, te.program, "torch", costs)
        got = te.infer(targets).embeddings
        trep = te.dispatch_report()
        tdec = te.dispatch._measured_assignment(BUCKET)
    assert tdec == jdec and set(tdec.values()) == {"sg"}
    assert trep["sources"] == jrep["sources"]
    assert trep["decisions"] == jrep["decisions"] == 3
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                               atol=ATOL * scale)
