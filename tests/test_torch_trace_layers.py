"""The port's tracer over the served path, on the CPU: exact span totals
and self time that survive ring eviction, the clock shared with
``time.perf_counter``, ``attach_tracer`` on a running server (earlier
batches untraced, one tracer), the spans a traced batch gets (the lane's
queue and admission, the dispatcher's wait on the host, Pack's parts),
the server's queue-wait counters, traced == untraced outputs, the
program's layer marks, the device spans resolved from timing events (fake
events here; the card's in ``tests/test_torch_gpu.py``) and the kernel
build counters."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.program import (compile_program,  # noqa: E402
                                      lower_and_specialize)
from repro_torch.gnn.model import GNNConfig, init_gnn  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import TraceConfig, Tracer  # noqa: E402
from repro_torch.obs.trace import (from_perf_counter, now,  # noqa: E402
                                   perf_counter_of)
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402

N = 16
C = 4


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=0.004, seed=1)


def _cfg(graph, kind="gcn", layers=2):
    return GNNConfig(kind=kind, n_layers=layers, receptive_field=N,
                     f_in=graph.feature_dim)


def _conf():
    return ServingConfig(device="cpu", impl="torch", batch_size=C,
                         num_threads=2)


class TestTotals:
    def test_exact_and_self_time_survive_ring_eviction(self):
        tr = Tracer(TraceConfig(ring_capacity=4, flight_k=0))
        outer = inner = 0.0
        for i in range(25):
            ctx = tr.maybe_trace(seq=i)
            with tr.span("outer", ctx=ctx):
                with tr.span("inner"):
                    time.sleep(1e-4)
            # after the fact, and before the root opened: no overlap
            tr.record_span("late", ctx, ctx.t_start - 10.0,
                           ctx.t_start - 9.5)
            tr.finish_ticket(ctx)
        spans = 25 * 4
        assert tr.spans_recorded == spans
        assert tr.spans_dropped == spans - 4
        tot = tr.totals()
        assert {k: v[0] for k, v in tot.items()} == {
            "outer": 25, "inner": 25, "late": 25, "batch": 25}
        # span times are epoch seconds: 2.4e-7 s apart at double precision
        assert tot["late"] == (25, pytest.approx(12.5, abs=1e-5),
                               pytest.approx(12.5, abs=1e-5))
        outer, inner = tot["outer"][1], tot["inner"][1]
        assert inner > 0 and tot["inner"][2] == inner
        # self time: less the host child's interval, which it contains
        assert tot["outer"][2] == pytest.approx(outer - inner, abs=1e-5)
        # the root holds "outer"; "late" lies outside its interval
        assert tot["batch"][2] == pytest.approx(tot["batch"][1] - outer,
                                                abs=1e-5)
        assert tr._kids == {}

    def test_overlapping_children_count_once(self):
        tr = Tracer(TraceConfig())
        ctx = tr.maybe_trace()
        t = ctx.t_start
        tr.record_span("a", ctx, t + 0.0, t + 2e-3)
        tr.record_span("b", ctx, t + 1e-3, t + 3e-3)
        while now() < t + 4e-3:
            time.sleep(1e-4)
        tr.finish_ticket(ctx)
        n, total, own = tr.totals()["batch"]
        assert n == 1 and own == pytest.approx(total - 3e-3, abs=1e-6)

    def test_perf_counter_of_maps_onto_perf_counter(self):
        tr = Tracer(TraceConfig())
        with tr.root_span("x"):
            p = time.perf_counter()
        sp = tr.export_spans()[0]
        assert perf_counter_of(sp["t0"]) <= p + 1e-6
        assert p <= perf_counter_of(sp["t0"] + sp["dur"]) + 1e-6
        assert abs(perf_counter_of(from_perf_counter(p)) - p) < 1e-6


class _Ev:
    """A stand-in CUDA event: ``elapsed_time`` in ms between two device
    times."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _resolve(marks):
    """A traced batch's device span (with a host child) closed on stand-in
    events at ``marks`` ([(label, ms after the anchor)]): the tracer, its
    spans, the device span, and the gpu.* spans as (name, l, start ms,
    end ms) after the anchor, sorted."""
    tr = Tracer(TraceConfig())
    t_a = now()
    tr._gpu_anchor = (_Ev(0.0), t_a)
    ctx = tr.maybe_trace()
    h = tr.open_span("device", ctx=ctx)
    with tr.activate(h):
        with tr.span("h2d.stage"):
            time.sleep(1e-4)
    h.marks = [(label, _Ev(ms)) for label, ms in marks]
    tr.close_span(h)
    tr.finish_ticket(ctx)
    assert h.marks is None
    spans = tr.export_spans()
    dev = next(s for s in spans if s["name"] == "device")
    # ms after the anchor (span times are epoch seconds: 2.4e-7 s apart)
    got = sorted((s["name"], s["args"].get("l"),
                  round(1e3 * (s["t0"] - t_a), 3),
                  round(1e3 * (s["t0"] + s["dur"] - t_a), 3))
                 for s in spans if s["name"].startswith("gpu."))
    return tr, spans, dev, got


def test_device_marks_resolve_into_gpu_spans():
    tr, spans, dev, got = _resolve([
        ("begin", 1.0), ("input", 2.0), ("attention.begin", 2.5),
        ("attention.end", 3.0), ("layer", 4.0), ("attention.begin", 4.25),
        ("attention.end", 4.5), ("layer", 6.0), ("tail", 6.5)])
    assert got == [("gpu.attention", 0, 2.5, 3.0),
                   ("gpu.attention", 1, 4.25, 4.5),
                   ("gpu.input", None, 1.0, 2.0),
                   ("gpu.layer", 0, 2.0, 4.0),
                   ("gpu.layer", 1, 4.0, 6.0),
                   ("gpu.tail", None, 6.0, 6.5)]
    for s in spans:
        if s["name"].startswith("gpu."):
            assert s["parent_id"] == dev["span_id"] and s["track"] == "gpu"
    # the device span's self time leaves out its host child, and only it
    tot = tr.totals()
    assert tot["device"][2] == pytest.approx(
        tot["device"][1] - tot["h2d.stage"][1], abs=1e-6)


def test_calibration_and_exploration_marks_make_no_span():
    """The sampled calibration and exploration passes end an interval of
    their own, kept out of layer 0, and get no span."""
    _, _, _, got = _resolve([
        ("begin", 1.0), ("input", 2.0), ("calibrate", 5.0),
        ("explore", 9.0), ("layer", 10.0), ("tail", 10.5)])
    assert got == [("gpu.input", None, 1.0, 2.0),
                   ("gpu.layer", 0, 9.0, 10.0),
                   ("gpu.tail", None, 10.0, 10.5)]


def test_engine_marks_its_calibration_and_exploration_passes(graph,
                                                             monkeypatch):
    """On a traced batch the engine marks where its sampled calibration
    pass and its dispatch warm-up pass end, before the served program's
    first layer (the marks a card resolves; recorded here by a stand-in
    marker)."""
    from repro_torch.core.dispatch import DispatchConfig
    conf = ServingConfig(
        device="cpu", impl="torch", batch_size=C, num_threads=2,
        mode="auto", trace=TraceConfig(calibrate_every=1),
        dispatch=DispatchConfig(warmup_passes=1, autotune_blocks=False))
    with DecoupledEngine(graph, _cfg(graph), config=conf) as eng:
        batches = []

        def gpu_marker(device):
            batches.append([])
            return batches[-1].append
        monkeypatch.setattr(eng.tracer, "gpu_marker", gpu_marker)
        eng.infer(np.arange(2 * C))
    assert len(batches) == 2
    for labels in batches:
        assert labels[:3] == ["begin", "input", "calibrate"]
        assert labels[-3:] == ["layer", "layer", "tail"]
    # the policy's warm-up pass runs on the first batch, not the second
    assert batches[0][3] == "explore" and "explore" not in batches[1]


def test_an_old_gpu_anchor_is_taken_again(monkeypatch):
    """The card's event timer drifts from the host's clock, so a device
    span resolves against an anchor at most ``ANCHOR_S`` old."""
    from repro_torch.obs import trace
    tr = Tracer(TraceConfig())
    tr._gpu_anchor = (_Ev(0.0), now() - 2 * trace.ANCHOR_S)
    fresh = []

    def anchor_gpu(device=None, tries=3):
        fresh.append(now())
        tr._gpu_anchor = (_Ev(50.0), fresh[-1])
    monkeypatch.setattr(tr, "anchor_gpu", anchor_gpu)
    ctx = tr.maybe_trace()
    h = tr.open_span("device", ctx=ctx)
    h.marks = [("begin", _Ev(40.0)), ("tail", _Ev(45.0))]
    tr.close_span(h)
    tr.finish_ticket(ctx)
    tail = next(s for s in tr.export_spans() if s["name"] == "gpu.tail")
    assert len(fresh) == 1
    assert tail["t0"] == pytest.approx(fresh[0] - 10e-3, abs=1e-6)
    assert tail["dur"] == pytest.approx(5e-3, abs=1e-6)


@pytest.mark.parametrize("kind,per_layer", [
    ("gcn", ["layer"]),
    ("gat", ["attention.begin", "attention.end", "layer"])])
def test_program_marks_each_layer_and_serves_the_same(graph, kind,
                                                      per_layer):
    cfg = _cfg(graph, kind, layers=3)
    prog, _ = lower_and_specialize(cfg, force="dense")
    params = init_gnn(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    adj = (rng.random((C, N, N)) < 0.2).astype(np.float32)
    batch = {"feats": torch.from_numpy(rng.standard_normal(
                 (C, N, cfg.f_in)).astype(np.float32)),
             "mask": torch.ones(C, N), "adj": torch.from_numpy(adj),
             "adj_mean": torch.from_numpy(adj / np.maximum(
                 adj.sum(-1, keepdims=True), 1))}
    run = compile_program(prog, "torch")
    labels = []
    with torch.inference_mode():
        want, _ = run(params, batch)
        got, _ = run(params, batch, mark=labels.append)
    assert labels == per_layer * 3 + ["tail"]
    assert torch.equal(want, got)


def _served(graph, kind, attach):
    """Every request of a server whose engine (plain path) has its tracer
    attached before the traffic, or none; the embeddings in order."""
    eng = DecoupledEngine(graph, _cfg(graph, kind), config=_conf())
    if attach:
        eng.attach_tracer(TraceConfig())
    targets = np.arange(24)
    out = eng.infer(targets).embeddings
    eng.close()
    return out


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_attached_tracer_serves_the_bits_of_none(graph, kind):
    np.testing.assert_array_equal(_served(graph, kind, False),
                                  _served(graph, kind, True))


class TestAttachWhileServing:
    @pytest.fixture(scope="class")
    def served(self, graph):
        """A running server with batches in flight when the tracer is
        attached (the device step is slowed so they queue)."""
        eng = DecoupledEngine(graph, _cfg(graph), config=_conf())
        slow = eng.scheduler.device_fn

        def device_fn(batch):
            time.sleep(0.02)
            return slow(batch)
        eng.scheduler.device_fn = device_fn
        tickets, admitted = [], []
        submit = eng.submit_chunk

        def submit_chunk(targets, **kw):
            t = submit(targets, **kw)
            admitted.append((len(targets), time.perf_counter()))
            tickets.append(t)
            return t
        eng.submit_chunk = submit_chunk
        srv = GNNServer(eng, max_wait_s=0.005)
        srv.start()
        reqs = [srv.submit(i) for i in range(40)]
        t_end = time.perf_counter() + 60
        while len(tickets) < 3 and time.perf_counter() < t_end:
            time.sleep(1e-3)
        before = list(tickets)
        in_flight = sum(not t.done() for t in before)
        tracer = eng.attach_tracer(TraceConfig())
        again = eng.attach_tracer(TraceConfig(sample_every=2))
        reqs += [srv.submit(i) for i in range(40, 80)]
        srv.drain(reqs, timeout=120)
        srv.stop()
        spans = tracer.export_spans()
        report = eng.trace_report()
        eng.close()
        return dict(tracer=tracer, again=again, before=before,
                    in_flight=in_flight, tickets=list(tickets),
                    spans=spans, reqs=reqs, admitted=admitted,
                    stats=srv.stats, report=report)

    def test_one_tracer_and_earlier_batches_untraced(self, served):
        assert served["again"] is served["tracer"]
        assert served["in_flight"] >= 1
        assert all(t.trace is None and t.tracer is None
                   for t in served["before"])
        traced = [t for t in served["tickets"] if t.trace is not None]
        assert traced and all(t.tracer is served["tracer"] for t in traced)
        roots = [s for s in served["spans"] if s["name"] == "batch"]
        assert len(roots) == len(traced)

    def test_each_batch_has_its_lane_and_dispatch_spans(self, served):
        spans = served["spans"]
        roots = {s["trace_id"]: s for s in spans if s["name"] == "batch"}
        for tid, root in roots.items():
            mine = [s for s in spans if s["trace_id"] == tid]
            for name in ("dispatch.wait_host", "lane.form", "lane.admit"):
                got = [s for s in mine if s["name"] == name]
                assert len(got) == 1, (name, mine)
                assert got[0]["parent_id"] == root["span_id"]
                assert got[0]["dur"] >= 0
            pack = next(s for s in mine if s["name"] == "pack")
            kids = [s for s in mine if s["name"].startswith("pack.")]
            assert sorted(s["name"] for s in kids) == [
                "pack.assemble", "pack.device_batch", "pack.payload"]
            for s in kids:
                assert s["parent_id"] == pack["span_id"]
                assert pack["t0"] <= s["t0"]
                assert s["t0"] + s["dur"] <= pack["t0"] + pack["dur"]
            dev = next(s for s in mine if s["name"] == "device")
            h2d = next(s for s in mine if s["name"] == "h2d.stage")
            assert h2d["parent_id"] == dev["span_id"]

    def test_no_gpu_spans_on_the_cpu(self, served):
        assert not [s for s in served["spans"]
                    if s["name"].startswith("gpu.")]
        assert "gpu_anchor_rtt_us" not in served["report"]

    def test_queue_wait_counters_match_the_requests_stamps(self, served):
        stats, reqs = served["stats"], served["reqs"]
        assert stats.n_admitted == len(reqs)
        # the requests in queue order, batch by batch; each batch admitted
        # just before this stamp (the lane reads its clock after)
        want, i = 0.0, 0
        for n, t_admit in served["admitted"]:
            want += sum(t_admit - r.t_enqueue for r in reqs[i:i + n])
            i += n
        assert i == len(reqs)
        assert 0.0 <= stats.queue_wait_s - want <= 1e-2 * len(reqs)
        assert stats.queue_wait_s <= sum(r.latency for r in reqs)


def test_build_counts_loads(monkeypatch):
    lib = object()
    monkeypatch.setattr(build, "build", lambda names: {})
    monkeypatch.setattr(build, "library_path", lambda name: f"/{name}.so")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: lib)
    before = build.stats()
    assert set(before) == {"built", "built_s", "loaded", "loaded_s"}
    try:
        assert build.load("probe") is lib
        assert build.load("probe") is lib      # cached: loaded once
    finally:
        build._libs.pop("probe", None)
    after = build.stats()
    assert after["loaded"] == before["loaded"] + 1
    assert after["loaded_s"] >= before["loaded_s"]
    assert after["built"] == before["built"]


def test_build_counters_are_thread_safe(monkeypatch):
    """Loads from many threads (more than cores, a short switch interval)
    lose no count."""
    import sys
    monkeypatch.setattr(build, "build", lambda names: {})
    monkeypatch.setattr(build, "library_path", lambda name: f"/{name}.so")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    names = [f"probe{i}" for i in range(64)]
    before = build.stats()["loaded"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=build.load, args=(n,))
                   for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        for n in names:
            build._libs.pop(n, None)
    assert build.stats()["loaded"] == before + len(names)
