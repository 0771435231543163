"""The multi-model server, the H100 DSE, the serve CLI and the streaming
histograms of the PyTorch package, on the CPU.

Mirrors tests/test_serve_runtime.py's ``TestSharedPlan`` and
``TestMultiModelServer`` within the port (impl="torch", device="cpu"),
then holds the port against the reference on the same inputs: a server of
each package on the same graph, targets, weights and config; the DSE's
``layer_costs`` FLOPs and bytes and ``program_alu_ops``; ``LogHistogram``
and ``Reservoir`` on the same records."""
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import dse as jdse  # noqa: E402
from repro.core.config import ServingConfig as JConfig  # noqa: E402
from repro.core.engine import DecoupledEngine as JEngine  # noqa: E402
from repro.core.program import program_alu_ops as j_alu_ops  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN, init_gnn as j_init  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro.obs import hist as jhist  # noqa: E402
from repro.serve.gnn_server import GNNServer as JServer  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.dse import (H100Spec, PlanViolation,  # noqa: E402
                                  explore, plan_covers, validate_models)
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.program import (AckProgram, Aggregate,  # noqa: E402
                                      Readout, Transform, program_alu_ops,
                                      register_lowering)
from repro_torch.gnn.layers import init_gcn_layer  # noqa: E402
from repro_torch.gnn.model import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.obs import hist  # noqa: E402
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# tests/test_torch_engine.py's tolerance: fp32 matmuls summed in another
# order by XLA and PyTorch, the absolute term in units of the output's
# largest magnitude
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=0.02, seed=1)   # ~1.8k vertices


def make_engine(graph, kind, batch_size=8, n_layers=2, n=32, **kw):
    cfg = GNNConfig(kind=kind, n_layers=n_layers, receptive_field=n,
                    f_in=graph.feature_dim)
    return DecoupledEngine(graph, cfg, config=ServingConfig(
        device="cpu", impl="torch", batch_size=batch_size, num_threads=2,
        **kw))


@dataclass(frozen=True)
class TanhTransform(Transform):
    """A Transform whose activation the plan's ALU set lacks."""

    @property
    def alu(self) -> frozenset:
        return super().alu | {"tanh"}


@register_lowering(
    "tanhgcn", layer_init=lambda cfg, gen, fi, fo: init_gcn_layer(gen, fi,
                                                                  fo))
def _lower_tanhgcn(cfg):
    layer = (Aggregate(norm="mean"), TanhTransform(w="w", b="b", act="relu"))
    return AckProgram(kind=cfg.kind, layer0=layer, inner=layer,
                      tail=(Readout(kind=cfg.readout),),
                      n_layers=cfg.n_layers)


class TestSharedPlan:
    def test_plan_covers(self):
        cfgs = [GNNConfig(kind=k, n_layers=2, receptive_field=64, f_in=128)
                for k in ("gcn", "sage", "gat")]
        plan = explore(cfgs)
        for c in cfgs:
            assert plan_covers(plan, c) == []
        assert plan.block_f == 64 and plan.ops_ok
        assert plan.smem_used == 197_712          # the tf32x3 block
        # GAT at N=8192: no attention variant fits a block (the row
        # kernel's scores alone are 9 x 8192 x 4 bytes)
        monster = GNNConfig(kind="gat", n_layers=2, receptive_field=8192,
                            f_in=128)
        reasons = plan_covers(plan, monster, H100Spec())
        assert reasons and "gat_attention" in reasons[0]
        with pytest.raises(PlanViolation, match="gat-L2-N8192"):
            validate_models(plan, [monster])

    def test_smem_follows_the_kernels_selectors(self):
        gat = GNNConfig(kind="gat", n_layers=2, receptive_field=256,
                        f_in=500, f_hidden=256, n_heads=4)
        ws = dse.smem_working_set(gat, e_pad=18688)
        assert ws == {"fused_gnn_layer": 197_712, "gat_attention": 111_888,
                      "scatter_gather_aggregate": 195_104}
        big = GNNConfig(kind="gcn", n_layers=2, receptive_field=1024,
                        f_in=500)
        assert dse.smem_working_set(big, e_pad=74496) == {
            "fused_gnn_layer": 16_384, "scatter_gather_aggregate": 0}

    def test_out_of_set_op_refused(self, graph):
        cfg = GNNConfig(kind="tanhgcn", n_layers=2, receptive_field=32,
                        f_in=graph.feature_dim)
        plan = explore([GNNConfig(kind="gcn", n_layers=2,
                                  receptive_field=32, f_in=8)])
        assert "ops ['tanh'] unsupported" in plan_covers(plan, cfg)
        assert not explore([cfg]).ops_ok
        eng = make_engine(graph, "tanhgcn")
        with pytest.raises(PlanViolation, match="unsupported op set"):
            GNNServer(max_wait_s=0.01).register("tanh", eng)
        eng.close()

    def test_register_rejects_model_outside_fixed_plan(self, graph):
        eng = make_engine(graph, "gcn")
        tight = H100Spec(max_smem=2 ** 10)        # nothing fits 1 KiB
        plan = explore([eng.cfg])
        srv = GNNServer(max_wait_s=0.01, plan=plan, spec=tight)
        with pytest.raises(PlanViolation):
            srv.register("gcn", eng)
        eng.close()

    @pytest.mark.parametrize("kind", ["gcn", "sage", "gin", "gat"])
    def test_costs_and_alu_ops_equal_the_reference(self, kind):
        kw = dict(kind=kind, n_layers=3, receptive_field=256, f_in=500,
                  f_hidden=256, n_heads=4)
        cfg, jcfg = GNNConfig(**kw), JGNN(**kw)
        assert program_alu_ops(cfg) == j_alu_ops(jcfg)
        for section, fi, fo in (("layer0", 500, 256), ("inner", 256, 256),
                                ("auto", 512, 256)):
            got = dse.layer_costs(cfg, 256, fi, fo, H100Spec(),
                                  section=section)
            want = jdse.layer_costs(jcfg, 256, fi, fo, jdse.TPUSpec(),
                                    section=section)
            assert (got["flops"], got["bytes"]) == (want["flops"],
                                                    want["bytes"])
            assert got["t_compute"] == got["flops"] / (494.7e12 / 3)
            assert got["t_memory"] == got["bytes"] / 3.35e12


class TestMultiModelServer:
    def test_two_kinds_concurrently_match_standalone(self, graph):
        engines = {k: make_engine(graph, k) for k in ("gcn", "sage")}
        srv = GNNServer(max_wait_s=0.01)
        for k, e in engines.items():
            srv.register(k, e)
        assert srv.plan is not None and srv.plan.ops_ok
        srv.start()
        rng = np.random.default_rng(0)
        reqs = []
        for t in rng.integers(0, graph.num_vertices, 32):
            reqs.append(srv.submit(int(t), model="gcn"))
            reqs.append(srv.submit(int(t) % 97, model="sage"))
        srv.drain(reqs, timeout=300)
        srv.stop()
        assert all(r.embedding is not None for r in reqs)
        for kind in ("gcn", "sage"):
            mine = [r for r in reqs if r.model == kind]
            tgts = np.array([r.target for r in mine])
            ref = engines[kind].infer(tgts, overlap=False).embeddings
            got = np.stack([r.embedding for r in mine])
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        rep = srv.report()
        for kind in ("gcn", "sage"):
            m = rep["models"][kind]
            assert m["latency"]["n"] == 32
            assert m["latency"]["p50"] <= m["latency"]["p90"] \
                <= m["latency"]["p99"]
            assert 0.0 <= m["stages"]["overlap"] <= 1.0
        assert rep["plan"]["block_f"] == 64
        assert rep["plan"]["smem_used"] == srv.plan.smem_used
        for e in engines.values():
            e.close()

    def test_single_model_backcompat(self, graph):
        eng = make_engine(graph, "gcn")
        srv = GNNServer(eng, max_wait_s=0.01)     # positional form
        srv.start()
        reqs = [srv.submit(i) for i in range(10)]
        srv.drain(reqs, timeout=120)
        srv.stop()
        p = srv.stats.percentiles()
        assert p["n"] == 10 and p["p99"] > 0
        eng.close()

    def test_unknown_model_rejected(self, graph):
        eng = make_engine(graph, "gcn")
        srv = GNNServer(max_wait_s=0.01)
        srv.register("gcn", eng)
        srv.register("gcn2", make_engine(graph, "gcn"))
        with pytest.raises(ValueError):
            srv.submit(0)                          # ambiguous: two models
        with pytest.raises(KeyError):
            srv.submit(0, model="nope")
        with pytest.raises(ValueError):
            srv.register("gcn", eng)               # duplicate name
        srv.engine_for("gcn2").close()
        eng.close()

    def test_drain_raises_on_failed_batch(self, graph):
        eng = make_engine(graph, "gcn", batch_size=4)
        srv = GNNServer(eng, max_wait_s=0.01)
        srv.start()
        bad = srv.submit(graph.num_vertices + 10**6)   # out-of-range vertex
        with pytest.raises(RuntimeError, match="failed"):
            srv.drain([bad], timeout=120)
        srv.stop()
        eng.close()

    def test_server_restart_serves_again(self, graph):
        eng = make_engine(graph, "gcn", batch_size=4)
        srv = GNNServer(eng, max_wait_s=0.01)
        srv.start()
        r1 = [srv.submit(i) for i in range(4)]
        srv.drain(r1, timeout=120)
        srv.stop()
        srv.start()
        r2 = [srv.submit(i) for i in range(4)]
        srv.drain(r2, timeout=120)
        srv.stop()
        np.testing.assert_allclose(np.stack([r.embedding for r in r1]),
                                   np.stack([r.embedding for r in r2]),
                                   rtol=1e-6)
        eng.close()

    def test_partial_tail_batch_padded_per_lane(self, graph):
        eng = make_engine(graph, "gcn", batch_size=8)
        srv = GNNServer(max_wait_s=0.01)
        srv.register("gcn", eng)
        srv.start()
        reqs = [srv.submit(i, model="gcn") for i in (5, 6, 7)]  # 3 < C=8
        srv.drain(reqs, timeout=120)
        srv.stop()
        ref = eng.infer(np.array([5, 6, 7]), overlap=False).embeddings
        got = np.stack([r.embedding for r in reqs])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        time.sleep(0)
        assert srv.model_stats("gcn").n_batches >= 1
        eng.close()

    def test_register_builds_the_engine_from_a_config(self, graph):
        srv = GNNServer(max_wait_s=0.01)
        cfg = GNNConfig(kind="gat", n_layers=2, receptive_field=32,
                        f_in=graph.feature_dim)
        srv.register("gat", graph=graph, cfg=cfg, config=ServingConfig(
            device="cpu", impl="torch", batch_size=4, num_threads=2))
        eng = srv.engine_for("gat")
        assert eng.device.type == "cpu" and eng.batch_size == 4
        with pytest.raises(TypeError):
            srv.register("x", eng, config=ServingConfig(device="cpu"))
        eng.close()


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_server_matches_the_reference_server(kind):
    """A reference server (impl="xla") and the port's (impl="torch",
    params carried across) on the same graph, targets and config: the
    embeddings of every request agree."""
    jg = j_get_graph("flickr", scale=0.02, seed=1)
    tg = get_graph("flickr", scale=0.02, seed=1)
    kw = dict(kind=kind, n_layers=2, receptive_field=32, f_in=jg.feature_dim)
    p = j_init(JGNN(**kw), jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
    je = JEngine(jg, JGNN(**kw), params=p, config=JConfig(
        batch_size=4, impl="xla", num_threads=2))
    te = DecoupledEngine(tg, GNNConfig(**kw), params=tp, config=ServingConfig(
        device="cpu", batch_size=4, impl="torch", num_threads=2))
    targets = [3, 8, 8, 40, 121, 7, 64, 90, 2, 300, 17]
    got = {}
    for name, srv in (("ref", JServer(je, max_wait_s=0.01)),
                      ("port", GNNServer(te, max_wait_s=0.01))):
        srv.start()
        reqs = [srv.submit(t) for t in targets]
        srv.drain(reqs, timeout=300)
        srv.stop()
        got[name] = np.stack([r.embedding for r in reqs])
        assert srv.report()["models"]["default"]["latency"]["n"] == 11
    je.close()
    te.close()
    want = got["ref"]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got["port"], want, rtol=RTOL,
                               atol=ATOL * scale)


def test_histograms_equal_the_reference_bitwise():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.lognormal(-4, 1.5, 5000), [0.0, 1e-9, 30.0]])
    ours, ref = hist.LogHistogram(), jhist.LogHistogram()
    ours_b, ref_b = hist.LogHistogram(), jhist.LogHistogram()
    res, jres = hist.Reservoir(64), jhist.Reservoir(64)
    for i, v in enumerate(vals):
        (ours if i % 3 else ours_b).record(float(v))
        (ref if i % 3 else ref_b).record(float(v))
        res.record(float(v))
        jres.record(float(v))
    ours.merge(ours_b)
    ref.merge(ref_b)
    assert json.dumps(ours.to_dict()) == json.dumps(ref.to_dict())
    assert ours.percentiles() == ref.percentiles()
    assert ours.mean == ref.mean and ours.nbytes == ref.nbytes
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.fraction_above(0.05) == ref.fraction_above(0.05)
    assert res.values() == jres.values()
    d1, d2 = ours.to_dict(), ours_b.to_dict()
    assert hist.merge_hist_dicts(d1, d2) == jhist.merge_hist_dicts(d1, d2)
    merged = hist.merge_hist_dicts(d1, d2)
    for q in (0.5, 0.99):
        assert hist.hist_dict_quantile(merged, q) == \
            jhist.hist_dict_quantile(merged, q)
    back = hist.LogHistogram.from_dict(ours.to_dict())
    assert back.to_dict() == ours.to_dict()


def test_serve_cli_on_the_cpu():
    """``python -m repro_torch.launch.serve --device cpu --impl torch``
    serves a small graph, prints the plan and the percentiles, and loads
    no jax."""
    code = ("import runpy, sys; sys.argv = ['serve', '--device', 'cpu', "
            "'--impl', 'torch', '--requests', '24', '--batch-size', '8', "
            "'--receptive-field', '32', '--layers', '2', '--scale', '0.02']; "
            "runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__'); "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules,"
            " sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "plan (H100): block_f=64" in out.stdout
    stats = json.loads(out.stdout[out.stdout.index("{"):])
    assert stats["n"] == 24 and stats["p50"] <= stats["p99"]


def test_serve_cli_defaults_to_the_card():
    """With no ``--device``, the CLI asks for CUDA and raises without a
    card (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = ("import sys; sys.argv = ['serve', '--requests', '4']; "
            "from repro_torch.launch.serve import main; main()")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
