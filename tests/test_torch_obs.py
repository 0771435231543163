"""The PyTorch package's tracing plane against the reference's: the flight
recorder keeps the same K slowest batches, span trees from a real pipeline
are well formed, each package's chrome trace passes the other's validator,
traced and untraced engines serve the same bits (impl "torch", and "cuda"
on the CPU through the kernels' plain versions), the trace report's keys
are the schema's, the server's report carries the trace section, and the
host stages annotate their spans with the reference's keys and values.
(The remote spans of the multi-host plane: tests/test_torch_rpc.py.)"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.config import ServingConfig as JConfig  # noqa: E402
from repro.core.engine import DecoupledEngine as JEngine  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro.obs import FlightRecorder as JFlightRecorder  # noqa: E402
from repro.obs import TraceConfig as JTraceConfig  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import validate_chrome_trace as j_validate  # noqa: E402
from repro.obs import to_chrome_trace as j_to_chrome  # noqa: E402
from repro.store import StorePolicy as JPolicy  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.report_schema import SCHEMA, SCHEMA_VERSION  # noqa: E402
from repro_torch.gnn.model import GNNConfig  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.obs import (CalibrationTable, FlightRecorder,  # noqa: E402
                             TraceConfig, Tracer, to_chrome_trace,
                             validate_chrome_trace)
from repro_torch.obs.export import main as export_main  # noqa: E402
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402
from repro_torch.store import StorePolicy  # noqa: E402

N = 16
C = 4
TARGETS = np.arange(12)


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=0.004, seed=1)


def _cfg(graph, kind="gcn"):
    return GNNConfig(kind=kind, n_layers=2, receptive_field=N,
                     f_in=graph.feature_dim)


def _conf(**kw):
    return ServingConfig(device="cpu", batch_size=C, num_threads=2, **kw)


def _assert_well_formed(spans):
    """No orphans, no negative durations, children inside parents'
    traces."""
    ids = {s["span_id"] for s in spans}
    by_id = {s["span_id"]: s for s in spans}
    assert len(ids) == len(spans), "duplicate span ids"
    for s in spans:
        assert s["dur"] >= 0, f"negative duration: {s}"
        if s["parent_id"] is not None:
            assert s["parent_id"] in ids, f"orphan span: {s}"
            assert by_id[s["parent_id"]]["trace_id"] == s["trace_id"], \
                "child crosses trace boundary"


def _spans(tracer, n=3):
    for i in range(n):
        ctx = tracer.maybe_trace(seq=i)
        with tracer.span("select", ctx=ctx):
            with tracer.span("inner"):
                pass
        h = tracer.open_span("device", ctx=ctx, tid=i % 16)
        with tracer.activate(h):
            with tracer.span("store.gather"):
                pass
        tracer.close_span(h)
        tracer.finish_ticket(ctx)
    return tracer.export_spans()


class TestFlightRecorder:
    def test_keeps_the_reference_k_slowest(self):
        durs = np.random.default_rng(2).uniform(0.001, 1.0, 50)
        mine, ref = FlightRecorder(4), JFlightRecorder(4)
        for i, d in enumerate(durs):
            assert mine.offer(i, float(d), [{"span": i}]) \
                == ref.offer(i, float(d), [{"span": i}])
        assert [e["trace_id"] for e in mine.entries()] \
            == [e["trace_id"] for e in ref.entries()]
        assert mine.summary() == ref.summary()


class TestTracerCore:
    def test_span_tree_well_formed(self):
        spans = _spans(Tracer(TraceConfig()))
        _assert_well_formed(spans)
        assert sum(1 for s in spans if s["name"] == "batch") == 3
        by_id = {s["span_id"]: s for s in spans}
        for name, parent in (("inner", "select"), ("store.gather",
                                                   "device")):
            for s in (s for s in spans if s["name"] == name):
                assert by_id[s["parent_id"]]["name"] == parent

    def test_untraced_span_is_noop(self):
        tr = Tracer(TraceConfig())
        with tr.span("anything") as h:
            assert h is None
        assert tr.open_span("device") is None
        tr.close_span(None)
        assert tr.spans_recorded == 0

    def test_sampling_and_ring_as_reference(self):
        mine = Tracer(TraceConfig(sample_every=3))
        ref = JTracer(JTraceConfig(sample_every=3))
        assert [mine.maybe_trace() is None for _ in range(9)] \
            == [ref.maybe_trace() is None for _ in range(9)]
        tr = Tracer(TraceConfig(ring_capacity=10, flight_k=0))
        _spans(tr, 20)
        assert len(tr.export_spans()) <= 10 and tr.spans_dropped > 0

    def test_config_validation(self):
        with pytest.raises(ValueError):
            TraceConfig(sample_every=0)
        with pytest.raises(ValueError):
            TraceConfig(calibrate_every=-1)
        assert TraceConfig().describe() == JTraceConfig().describe()


class TestChromeExport:
    def test_each_side_validates_the_other(self):
        mine = to_chrome_trace(_spans(Tracer(TraceConfig())))
        jt = JTracer(JTraceConfig())
        for i in range(3):
            ctx = jt.maybe_trace(seq=i)
            with jt.span("select", ctx=ctx):
                with jt.span("inner"):
                    pass
            jt.finish_ticket(ctx)
        ref = j_to_chrome(jt.export_spans())
        assert validate_chrome_trace(mine) == [] and j_validate(mine) == []
        assert validate_chrome_trace(ref) == [] and j_validate(ref) == []

    def test_validator_catches_broken_traces(self):
        b = {"ph": "B", "name": "x", "pid": 1, "tid": 1, "ts": 0.0,
             "args": {}}
        e = {"ph": "E", "name": "x", "pid": 1, "tid": 1, "ts": 1.0}
        dangling = dict(b, args={"span_id": 1, "parent_id": 999})
        for tree in ({"traceEvents": [b]}, {"traceEvents": [e]},
                     {"traceEvents": [dangling, dict(e)]}):
            assert validate_chrome_trace(tree) == j_validate(tree) != []

    def test_cli_roundtrip(self, tmp_path):
        dump = tmp_path / "spans.json"
        dump.write_text(json.dumps(_spans(Tracer(TraceConfig()), 1)))
        out = tmp_path / "out.trace.json"
        assert export_main([str(dump), "-o", str(out)]) == 0
        assert export_main([str(out), "--validate"]) == 0
        assert j_validate(json.loads(out.read_text())) == []


class TestEngineTracing:
    @pytest.mark.parametrize("impl", ["torch", "cuda"])
    @pytest.mark.parametrize("kind", ["gcn", "gat"])
    def test_traced_equals_untraced(self, graph, kind, impl):
        cfg = _cfg(graph, kind)
        with DecoupledEngine(graph, cfg, config=_conf(impl=impl)) as eng:
            ref = eng.infer(TARGETS).embeddings
            assert eng.trace_report() == {"enabled": False}
            with pytest.raises(ValueError):
                eng.export_trace("never.json")
        with DecoupledEngine(graph, cfg, config=_conf(
                impl=impl, trace=TraceConfig(calibrate_every=1))) as eng:
            out = eng.infer(TARGETS).embeddings
            rep = eng.trace_report()
        np.testing.assert_array_equal(ref, out)
        assert rep["enabled"] and rep["tickets_traced"] == 3
        assert rep["calibration"]["passes"] == 3
        assert rep["explore_failures"] == 0
        for key in rep:
            assert key in SCHEMA["trace"], f"undocumented trace key {key}"

    def test_span_tree_from_real_pipeline(self, graph, tmp_path):
        with DecoupledEngine(graph, _cfg(graph), config=_conf(
                trace=TraceConfig())) as eng:
            eng.infer(TARGETS)
            spans = eng.tracer.export_spans()
            tree = eng.export_trace(str(tmp_path / "t.json"))
        _assert_well_formed(spans)
        for tid in {s["trace_id"] for s in spans if s["name"] == "batch"}:
            names = {s["name"] for s in spans if s["trace_id"] == tid}
            assert {"batch", "select", "build", "pack", "device",
                    "store.gather"} <= names
        assert validate_chrome_trace(tree) == [] and j_validate(tree) == []
        assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]

    def test_flight_recorder_in_engine(self, graph):
        with DecoupledEngine(graph, _cfg(graph), config=_conf(
                trace=TraceConfig(flight_k=2))) as eng:
            eng.infer(np.arange(24))     # 6 batches
            rep = eng.trace_report()
        assert (rep["flight"]["k"], rep["flight"]["retained"],
                rep["flight"]["offered"]) == (2, 2, 6)
        durs = [s["dur"] for s in rep["flight"]["slowest"]]
        assert durs == sorted(durs, reverse=True)

    def test_calibration_table_rows(self):
        t = CalibrationTable()
        for d in (0.001, 0.002, 0.003):
            t.record("Aggregate", "torch/dense", 10, d)
        rows = t.rows()
        assert len(rows) == 1 and rows[0]["count"] == 3
        assert round(t.lookup("Aggregate", "torch/dense", 10), 9) \
            == rows[0]["p50_s"]


def test_server_report_has_trace_section(graph):
    eng = DecoupledEngine(graph, _cfg(graph), config=_conf(
        trace=TraceConfig()))
    srv = GNNServer(eng, max_wait_s=0.01)
    srv.start()
    reqs = [srv.submit(i) for i in range(8)]
    srv.drain(reqs, timeout=120)
    srv.stop()
    rep = srv.report()
    eng.close()
    assert rep["schema_version"] == SCHEMA_VERSION
    lane = rep["models"]["default"]
    assert lane["trace"]["enabled"]
    assert lane["trace"]["tickets_traced"] >= 1
    assert "dispatch" not in lane
    for key in lane["trace"]:
        assert key in SCHEMA["trace"]


@pytest.mark.parametrize("nbr_cache", ["none", "lru"])
def test_host_stage_span_args_equal_the_reference(graph, nbr_cache):
    """Select (nbr hits/misses, targets; on the cached path), Build (row
    cache hits/misses) and Pack (bytes shipped / dense) annotate their
    spans with the reference's keys and values, batch by batch."""
    jg = j_get_graph("flickr", scale=0.004, seed=1)
    jcfg = JGNN(kind="gcn", n_layers=2, receptive_field=N,
                f_in=jg.feature_dim)
    targets = np.array([3, 3, 7, 11, 7, 3, 2, 9])    # repeats: cache hits
    args = {}
    for name, eng in (
            ("port", DecoupledEngine(graph, _cfg(graph), config=_conf(
                impl="torch", trace=TraceConfig(),
                store=StorePolicy(nbr_cache=nbr_cache)))),
            ("ref", JEngine(jg, jcfg, config=JConfig(
                batch_size=C, num_threads=2, trace=JTraceConfig(),
                store=JPolicy(nbr_cache=nbr_cache))))):
        with eng:
            eng.infer(targets, overlap=False)
            eng.infer(targets)
            spans = eng.tracer.export_spans()
        # each span under its batch's ordinal: trace and span ids share
        # one counter, so the gap between two batches' trace ids depends
        # on how many spans other threads opened in between
        batch = {t: i for i, t in enumerate(sorted({x["trace_id"]
                                                     for x in spans}))}
        args[name] = sorted(
            (batch[s["trace_id"]], s["name"],
             sorted((k, v) for k, v in s["args"].items() if k != "tid"))
            for s in spans if s["name"] in ("select", "build", "pack"))
    assert len(args["port"]) == 3 * 2          # the pipelined batches
    assert args["port"] == args["ref"]
    keys = {n: {k for k, _ in a} for _, n, a in args["port"]}
    assert {"bytes_shipped", "bytes_dense"} <= keys["pack"]
    if nbr_cache == "lru":           # the cached paths annotate
        assert {"nbr_hits", "nbr_misses", "n_targets"} <= keys["select"]
        assert {"build_hits", "build_misses"} <= keys["build"]
