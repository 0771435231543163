"""The telemetry plane of the PyTorch package, on the CPU.

Mirrors tests/test_telemetry.py within the port: registry semantics,
lossless window and cluster merge, Prometheus exposition and its
validator, the HTTP endpoint, the cluster scrape over the RPC pool, SLO
burn-rate math, watchdog detections, the hub, the event ring, the engine
(metered == unmetered, bitwise) and the trajectory regression gate. Then
across the two packages: the same observations under a fake clock give
the same wire, and one wire renders to the same text in both. Last, what
the port adds: the dispatch counters (the reference's
``test_dispatch_metrics_exposed``), the device stage's histogram beside
the host stages, a metered server scraped over HTTP, and
scripts/torch_metrics_smoke.py run on the CPU."""
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import promexp as j_promexp  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.dispatch import DispatchConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.report_schema import SCHEMA, SCHEMA_VERSION  # noqa: E402
from repro_torch.distributed.graph_host import GraphHostService  # noqa: E402
from repro_torch.distributed.rpc import (HostPool,  # noqa: E402
                                         InProcTransport, TransportError)
from repro_torch.gnn.model import GNNConfig  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.obs import (EventRing, LogHistogram,  # noqa: E402
                             MetricsHTTPServer, MetricsRegistry,
                             SLObjective, SLOTracker, Telemetry,
                             TelemetryConfig, Watchdog, WindowedHistogram,
                             inject_labels, merge_hist_dicts, merge_wire,
                             render_wire, series_count, validate_exposition)
from repro_torch.obs.regress import (check_trajectory,  # noqa: E402
                                     main as regress_main)
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402

N = 16
C = 4
SCALE = 0.004
SEED = 1


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=SCALE, seed=SEED)


def _cfg(graph, kind="gcn"):
    return GNNConfig(kind=kind, n_layers=2, receptive_field=N,
                     f_in=graph.feature_dim)


def _sc(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("impl", "torch")
    kw.setdefault("batch_size", C)
    kw.setdefault("num_threads", 2)
    return ServingConfig(**kw)


class _Clock:
    """Deterministic manual clock for window-rotation tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TestRegistry:
    def test_counter_and_gauge_semantics(self):
        reg = MetricsRegistry("h")
        c = reg.counter("repro_x_total", help="x")
        c.inc()
        c.inc(3)
        assert c.value == 4
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("repro_depth")
        g.set(7)
        g.add(-2)
        assert g.value == 5
        # same name + labels -> same object; new labels -> new series
        assert reg.counter("repro_x_total") is c
        c2 = reg.counter("repro_x_total", shard="1")
        assert c2 is not c
        assert series_count(reg.collect()) == 3

    def test_type_conflict_raises(self):
        reg = MetricsRegistry("h")
        reg.counter("repro_x_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("repro_x_total")

    def test_callback_series_and_dead_callback(self):
        reg = MetricsRegistry("h")
        src = {"hits": 0}
        reg.counter_fn("repro_hits_total", lambda: src["hits"])
        src["hits"] = 9
        wire = reg.collect()
        row = wire["families"]["repro_hits_total"]["series"][0]
        assert row["value"] == 9.0

        def dead():
            raise RuntimeError("source gone")

        reg.gauge_fn("repro_dead", dead)
        wire = reg.collect()                 # scrape must survive
        assert wire["families"]["repro_dead"]["series"] == []

    def test_window_merge_equals_whole_run(self):
        """Merging every retained window + current is bitwise the
        histogram of all samples (lossless window merge)."""
        clk = _Clock()
        wh = WindowedHistogram(window_s=1.0, windows=8, clock=clk)
        ref = LogHistogram()
        rng = np.random.default_rng(0)
        for i in range(400):
            v = float(rng.gamma(2.0, 0.005))
            wh.record(v)
            ref.record(v)
            if i % 60 == 59:
                clk.advance(1.1)             # rotate a window
        merged = wh.merged()
        assert merged.count == ref.count == 400
        assert merged.to_dict() == ref.to_dict()

    def test_idle_gap_produces_empty_windows(self):
        clk = _Clock()
        wh = WindowedHistogram(window_s=1.0, windows=4, clock=clk)
        wh.record(0.01)
        clk.advance(3.5)                     # 3 whole windows idle
        wh.record(0.02)
        assert wh.window_counts().count(0) >= 2
        assert wh.merged().count == 2

    def test_merge_hist_dicts_lossless(self):
        a, b = LogHistogram(), LogHistogram()
        for v in (0.001, 0.02, 0.3):
            a.record(v)
        for v in (0.004, 4.0):
            b.record(v)
        ref = LogHistogram()
        ref.merge(a)
        ref.merge(b)
        # survive a JSON round trip (string bucket keys), like the RPC
        ad = json.loads(json.dumps(a.to_dict()))
        merged = merge_hist_dicts(ad, b.to_dict())
        assert merged["count"] == 5
        assert merged["counts"] == \
            {int(k): v for k, v in ref.to_dict()["counts"].items()}
        assert merged["p99"] == ref.to_dict()["p99"]


class TestWireMerge:
    def _reg(self, host, n_hist, n_count):
        reg = MetricsRegistry(host)
        wh = reg.whist("repro_batch_seconds")
        for i in range(n_hist):
            wh.record(0.001 * (i + 1))
        reg.counter("repro_batches_total").inc(n_count)
        return reg

    def test_two_host_merge_is_sum(self):
        a = self._reg("host-a", 4, 4)
        b = self._reg("host-b", 2, 10)
        m = merge_wire([a.collect(), b.collect()])
        assert m["hosts"] == ["host-a", "host-b"]
        fam = m["families"]["repro_batch_seconds"]["series"][0]
        assert fam["total"]["count"] == 6          # 4 + 2, lossless
        cnt = m["families"]["repro_batches_total"]["series"][0]
        assert cnt["value"] == 14.0
        assert validate_exposition(render_wire(m)) == []

    def test_merge_type_conflict_raises(self):
        a = MetricsRegistry("a")
        a.counter("repro_x_total").inc()
        b = MetricsRegistry("b")
        b.gauge("repro_x_total").set(1)
        with pytest.raises(ValueError, match="one host"):
            merge_wire([a.collect(), b.collect()])

    def test_inject_labels_keeps_series_distinct(self):
        a = self._reg("a", 1, 1)
        b = self._reg("b", 1, 1)
        m = merge_wire([inject_labels(a.collect(), model="m0"),
                        inject_labels(b.collect(), model="m1")])
        fam = m["families"]["repro_batches_total"]
        assert len(fam["series"]) == 2           # distinct by model=


class TestExposition:
    def _wire(self):
        reg = MetricsRegistry("h")
        reg.counter("repro_req_total", help='say "hi"\nok',
                    model="gcn").inc(3)
        reg.gauge("repro_backlog").set(2.5)
        wh = reg.whist("repro_lat_seconds", stage="build")
        for v in (0.001, 0.01, 0.1):
            wh.record(v)
        return reg.collect()

    def test_render_validates_clean(self):
        text = render_wire(self._wire())
        assert validate_exposition(text) == []
        assert 'model="gcn"' in text
        assert "# TYPE repro_lat_seconds histogram" in text
        assert 'le="+Inf"' in text

    def test_validator_rejects_malformed(self):
        bad = "\n".join([
            "# TYPE repro_a counter",
            "repro_a 1",
            "repro_a 2",                     # duplicate series
            "repro-b 3",                     # bad metric name
            "repro_c{le=\"0.1\"} nope",      # bad value
        ])
        assert len(validate_exposition(bad)) >= 3

    def test_validator_rejects_nonmonotone_buckets(self):
        bad = "\n".join([
            "# TYPE repro_h histogram",
            'repro_h_bucket{le="0.1"} 5',
            'repro_h_bucket{le="0.2"} 3',    # cumulative decreased
            'repro_h_bucket{le="+Inf"} 5',
            "repro_h_count 5",
            "repro_h_sum 0.5",
        ])
        assert any("non-decreasing" in p or "cumulative" in p
                   for p in validate_exposition(bad))

    def test_http_endpoint(self):
        wire = self._wire()
        srv = MetricsHTTPServer(lambda: render_wire(wire))
        try:
            with urllib.request.urlopen(srv.url, timeout=5) as r:
                assert r.status == 200
                body = r.read().decode()
            assert validate_exposition(body) == []
            health = srv.url.rsplit("/", 1)[0] + "/healthz"
            with urllib.request.urlopen(health, timeout=5) as r:
                assert r.status == 200
        finally:
            srv.close()


class TestClusterScrape:
    def test_two_graph_hosts_scrape_merge(self, graph):
        """metrics() over the pool: per-host registries merge into one
        cluster view whose counts are the per-host sums."""
        tc = TelemetryConfig(window_s=60.0)
        svc_a = GraphHostService(graph, num_threads=1, telemetry=tc)
        svc_b = GraphHostService(graph, num_threads=1, telemetry=tc)
        pool = HostPool([InProcTransport(svc_a, owns_service=True),
                         InProcTransport(svc_b, owns_service=True)])
        try:
            for i in range(6):
                payload = {"targets": np.asarray([i], np.int64),
                           "n": N, "alpha": 0.15, "eps": 1e-4,
                           "e_pad": 64}
                pool.call("select_build", payload, affinity=i)
            wires = pool.broadcast("metrics", None)
            assert len(wires) == 2
            per_host = [w["families"]["repro_host_requests_total"]
                        ["series"][0]["value"] for w in wires]
            merged = merge_wire(wires)
            assert len(merged["hosts"]) == 2
            fam = merged["families"]["repro_host_requests_total"]
            assert fam["series"][0]["value"] == sum(per_host) == 6
            sel = merged["families"]["repro_host_select_seconds"]
            assert sel["series"][0]["total"]["count"] == 6
            assert validate_exposition(render_wire(merged)) == []
        finally:
            pool.close()

    def test_metrics_method_off_returns_empty(self, graph):
        svc = GraphHostService(graph, num_threads=1)
        assert svc.metrics()["families"] == {}


class TestSLO:
    def _tracker(self, slo, **kw):
        cfg = TelemetryConfig(window_s=60.0, slos=(slo,),
                              min_samples=kw.pop("min_samples", 8), **kw)
        reg = MetricsRegistry("h")
        events = EventRing()
        return SLOTracker(cfg, reg, events), reg, events

    def test_latency_burn_rate_math(self):
        o = SLObjective(name="p999-50ms", threshold_s=0.050, target=0.999)
        tracker, reg, events = self._tracker(o)
        wh = reg.whist("repro_batch_seconds")
        for _ in range(99):
            wh.record(0.001)
        wh.record(0.500)                     # 1% above threshold
        (row,) = tracker.evaluate()
        # bad fraction 0.01 over budget 0.001 => burn 10x: above the slow
        # bar (6) but below the fast bar (14.4)
        assert row["burn"]["fast"]["short"] == pytest.approx(10.0)
        assert row["status"] == "breach"
        assert events.snapshot(kind="slo_breach")[0]["severity"] == "warn"

    def test_ok_then_fast_breach(self):
        o = SLObjective(name="lat", threshold_s=0.050, target=0.999)
        tracker, reg, events = self._tracker(o)
        wh = reg.whist("repro_batch_seconds")
        for _ in range(200):
            wh.record(0.001)
        assert tracker.evaluate()[0]["status"] == "ok"
        for _ in range(20):                  # 10% bad -> burn 100x
            wh.record(0.500)
        row = tracker.evaluate()[0]
        assert row["status"] == "breach"
        assert row["burn"]["fast"]["short"] > 14.4
        assert events.snapshot(kind="slo_breach")[-1]["severity"] == "crit"

    def test_min_samples_gate(self):
        o = SLObjective(name="lat", threshold_s=0.050, target=0.999)
        tracker, reg, _ = self._tracker(o, min_samples=64)
        wh = reg.whist("repro_batch_seconds")
        for _ in range(4):
            wh.record(1.0)                   # all bad, but tiny n
        assert tracker.evaluate()[0]["status"] == "ok"

    def test_error_rate_objective(self):
        o = SLObjective(name="errs", kind="error_rate", target=0.99)
        tracker, reg, _ = self._tracker(o)
        good = reg.counter("repro_batches_total")
        bad = reg.counter("repro_batch_errors_total")
        good.inc(100)
        tracker.evaluate()                   # set marks
        good.inc(100)
        bad.inc(50)                          # 50% errors since last eval
        assert tracker.evaluate()[0]["status"] == "breach"

    def test_missing_metric_is_no_data(self):
        o = SLObjective(name="ghost", metric="repro_nope_seconds")
        tracker, _, _ = self._tracker(o)
        assert tracker.evaluate()[0]["status"] == "no_data"


class TestWatchdog:
    def _wd(self, **kw):
        cfg = TelemetryConfig(window_s=60.0,
                              min_samples=kw.pop("min_samples", 8), **kw)
        reg = MetricsRegistry("h")
        events = EventRing()
        return Watchdog(cfg, reg, events), reg, events

    def test_p99_drift_fires_within_one_window(self):
        wd, reg, events = self._wd()
        wh = reg.whist("repro_batch_seconds")
        for _ in range(3):                   # healthy baseline windows
            for _ in range(32):
                wh.record(0.002)
            wh.rotate()
        assert wd.check()["fired"] == {}
        for _ in range(32):                  # 10x p99 step
            wh.record(0.020)
        wh.rotate()
        summary = wd.check()
        assert summary["fired"].get("p99_regression") == 1
        ev = events.snapshot(kind="p99_regression")[0]
        assert ev["data"]["factor"] >= 9.0
        wd.check()                           # debounced: fires once
        assert wd.summary()["fired"]["p99_regression"] == 1

    def test_p99_drift_ignores_thin_windows(self):
        wd, reg, _ = self._wd(min_samples=16)
        wh = reg.whist("repro_batch_seconds")
        for _ in range(3):
            for _ in range(4):               # < min_samples per window
                wh.record(0.002)
            wh.rotate()
        wh.record(1.0)
        wh.rotate()
        assert wd.check()["fired"] == {}

    def test_cache_hit_collapse(self):
        wd, reg, events = self._wd()
        hits = reg.counter("repro_nbr_cache_hits_total")
        misses = reg.counter("repro_nbr_cache_misses_total")
        hits.inc(90)
        misses.inc(10)                       # lifetime 90%
        wd.check()                           # set marks
        misses.inc(100)                      # window rate ~0%
        assert wd.check()["fired"].get("cache_hit_collapse") == 1
        assert events.snapshot(kind="cache_hit_collapse")

    def test_backlog_growth(self):
        wd, reg, _ = self._wd(backlog_growth_checks=3)
        g = reg.gauge("repro_refresh_backlog")
        for level in (1, 2, 3):
            g.set(level)
            wd.check()
        assert wd.summary()["fired"] == {}   # needs checks+1 points
        g.set(4)
        wd.check()
        assert wd.summary()["fired"]["backlog_growth"] == 1
        g.set(1)                             # recovery re-arms
        wd.check()
        assert wd.summary()["active"] == []

    def test_quarantine_event_from_host_pool(self, graph):
        """HostPool fires on_quarantine once per episode."""
        svc = GraphHostService(graph, num_threads=1)

        class Flaky(InProcTransport):
            def call(self, method, payload, timeout=None):
                if method == "select_build":
                    raise TransportError("boom")
                return super().call(method, payload, timeout)

        seen = []
        pool = HostPool([Flaky(svc), InProcTransport(
            svc, owns_service=True)], retries=1,
            on_quarantine=lambda ep: seen.append(ep))
        try:
            payload = {"targets": np.asarray([1], np.int64), "n": N,
                       "alpha": 0.15, "eps": 1e-4, "e_pad": 64}
            for _ in range(4):
                pool.call("select_build", payload, affinity=0)
            assert len(seen) == 1            # one episode, one event
        finally:
            pool.close()


class TestTelemetryHub:
    def test_observe_batch_and_report(self):
        t = Telemetry(TelemetryConfig(window_s=60.0), host="client")
        try:
            for i in range(10):
                t.observe_batch(0.004, {"select": 0.001, "build": 0.002},
                                error=(i == 9))
            rep = t.report()
            assert rep["enabled"] is True
            assert rep["counters"]["repro_batches_total"] == 10
            assert rep["counters"]["repro_batch_errors_total"] == 1
            assert rep["hists"]["repro_batch_seconds"]["count"] == 10
            assert "repro_stage_seconds{stage=build}" in rep["hists"]
            assert rep["series"] >= 4
        finally:
            t.close()

    def test_report_covers_schema(self):
        assert SCHEMA_VERSION >= 4 and "telemetry" in SCHEMA
        t = Telemetry(TelemetryConfig(slos=(SLObjective(name="lat"),)))
        try:
            t.observe_batch(0.001, {})
            t.evaluate()
            rep = t.report()
        finally:
            t.close()
        assert set(rep) == set(SCHEMA["telemetry"])

    def test_background_eval_thread(self):
        import time as _time
        t = Telemetry(TelemetryConfig(eval_every_s=0.02))
        try:
            deadline = _time.monotonic() + 5.0
            while t.evaluations == 0 and _time.monotonic() < deadline:
                _time.sleep(0.01)
            assert t.evaluations > 0
        finally:
            t.close()
        assert t._thread is None

    def test_config_validation(self):
        with pytest.raises(ValueError):
            TelemetryConfig(window_s=0)
        with pytest.raises(ValueError):
            TelemetryConfig(windows=0)
        with pytest.raises(ValueError):
            TelemetryConfig(port=70000)
        with pytest.raises(ValueError):
            TelemetryConfig(hit_floor_ratio=1.5)
        with pytest.raises(TypeError):
            TelemetryConfig(slos=("not-an-slo",))
        with pytest.raises(TypeError):
            ServingConfig(device="cpu", telemetry="yes")
        with pytest.raises(TypeError):       # the reference's config
            ServingConfig(device="cpu",
                          telemetry=j_metrics.TelemetryConfig())


class TestEventRing:
    def test_bounded_with_drop_accounting(self):
        ring = EventRing(capacity=4)
        for i in range(10):
            ring.emit("k", severity="info", message=str(i))
        assert len(ring) == 4
        s = ring.summary()
        assert s["emitted"] == 10 and s["dropped"] == 6
        assert [e["message"] for e in ring.snapshot()] == \
            ["6", "7", "8", "9"]

    def test_severity_filter_and_validation(self):
        ring = EventRing()
        ring.emit("a", severity="info")
        ring.emit("b", severity="crit")
        assert [e["kind"] for e in
                ring.snapshot(min_severity="warn")] == ["b"]
        with pytest.raises(ValueError):
            ring.emit("c", severity="fatal")


class TestEngineIntegration:
    @pytest.mark.parametrize("impl", ["torch", "cuda"])
    @pytest.mark.parametrize("overlap", [False, True])
    def test_metrics_off_is_bitwise_identical(self, graph, impl, overlap):
        cfg = _cfg(graph)
        targets = np.arange(12)
        outs = {}
        for name, tele in (("off", None), ("on", TelemetryConfig())):
            with DecoupledEngine(graph, cfg, config=_sc(
                    impl=impl, telemetry=tele)) as eng:
                outs[name] = eng.infer(targets,
                                       overlap=overlap).embeddings
        np.testing.assert_array_equal(outs["off"], outs["on"])

    def test_engine_wire_and_off_raises(self, graph):
        cfg = _cfg(graph)
        with DecoupledEngine(graph, cfg, config=_sc(
                telemetry=TelemetryConfig())) as eng:
            eng.infer(np.arange(8), overlap=False)
            wire = eng.metrics_wire()
            assert series_count(wire) >= 8
            assert validate_exposition(eng.metrics_text()) == []
            rep = eng.telemetry_report()
            assert rep["counters"]["repro_batches_total"] >= 1
        with DecoupledEngine(graph, cfg, config=_sc()) as eng:
            assert eng.telemetry_report() == {"enabled": False}
            with pytest.raises(ValueError):
                eng.metrics_wire()

    @pytest.mark.parametrize("overlap", [False, True])
    def test_device_stage_histogram_counts_batches(self, graph, overlap):
        """The device stage is observed beside the host stages, once a
        batch, on both the pipelined and the serial path."""
        with DecoupledEngine(graph, _cfg(graph), config=_sc(
                telemetry=TelemetryConfig())) as eng:
            eng.infer(np.arange(20), overlap=overlap)
            hists = eng.telemetry_report()["hists"]
        assert hists["repro_stage_seconds{stage=device}"]["count"] == 5
        for st in ("select", "build", "pack"):
            assert hists[f"repro_stage_seconds{{stage={st}}}"]["count"] == 5
        assert hists["repro_batch_seconds"]["count"] == 5

    def test_remote_engine_cluster_scrape(self, graph):
        """A metered engine behind the loopback transport: its wire merges
        the graph host's registry, and the rpc counters join the plane."""
        with DecoupledEngine(graph, _cfg(graph), config=_sc(
                transport="inproc",
                telemetry=TelemetryConfig())) as eng:
            eng.infer(np.arange(12))
            wire = eng.metrics_wire()
            local = eng.metrics_wire(cluster=False)
            text = eng.metrics_text()
        fams = wire["families"]
        assert fams["repro_host_select_seconds"]["series"][0][
            "total"]["count"] == 3
        assert fams["repro_rpc_calls_total"]["series"][0]["value"] == 3
        assert "repro_host_select_seconds" not in local["families"]
        assert len(wire["hosts"]) == 2
        assert validate_exposition(text) == []

    def test_dispatch_metrics_exposed(self, graph):
        """The port's counterpart of the reference's
        test_dispatch_metrics_exposed (tests/test_dispatch.py)."""
        cfg = GNNConfig(kind="gcn", n_layers=2, receptive_field=N,
                        f_in=graph.feature_dim, f_hidden=128)
        with DecoupledEngine(graph, cfg, config=_sc(
                batch_size=2, mode="auto", telemetry=TelemetryConfig(),
                dispatch=DispatchConfig(warmup_passes=1,
                                        autotune_blocks=False))) as eng:
            eng.infer(np.arange(8))
            text = eng.metrics_text(cluster=False)
        assert "repro_dispatch_total" in text
        assert 'source="warmup"' in text
        assert "repro_variant_cache_hits_total" in text
        assert "repro_dispatch_decisions_total" in text
        assert validate_exposition(text) == []

    def test_forced_mode_dispatch_counted_forced(self, graph):
        with DecoupledEngine(graph, _cfg(graph), config=_sc(
                mode="dense", telemetry=TelemetryConfig(),
                dispatch=DispatchConfig(autotune_blocks=False))) as eng:
            eng.infer(np.arange(8))
            rep = eng.telemetry_report()["counters"]
        forced = {k: v for k, v in rep.items()
                  if k.startswith("repro_dispatch_total")}
        assert forced and all("source=forced" in k and v == 2
                              for k, v in forced.items())



class TestRegressGate:
    def _points(self, *vals):
        return [{"regress": {"p50_ms": v}} for v in vals]

    def test_ok_and_regression(self):
        rows = check_trajectory(self._points(10, 11, 10, 10.5))
        assert rows[0]["status"] == "ok"
        rows = check_trajectory(self._points(10, 11, 10, 20))
        assert rows[0]["status"] == "regression"

    def test_young_trajectory_passes(self):
        rows = check_trajectory(self._points(10, 20))
        assert rows[0]["status"] == "insufficient_history"

    def test_cli_exit_codes(self, tmp_path, capsys):
        p = tmp_path / "BENCH_x.json"
        p.write_text(json.dumps(self._points(10, 10, 10, 10)))
        assert regress_main(["--results-dir", str(tmp_path)]) == 0
        p.write_text(json.dumps(self._points(10, 10, 10, 99)))
        assert regress_main(["--results-dir", str(tmp_path)]) == 1
        out = capsys.readouterr().out
        assert "REGRESSION" in out and "regress: FAIL" in out

class TestAcrossPackages:
    def _observe(self, mod):
        clk = _Clock()
        reg = mod.MetricsRegistry("h", window_s=1.0, windows=3, clock=clk)
        wh = reg.whist("repro_lat_seconds", help="latency", stage="build")
        c = reg.counter("repro_req_total", help="requests", model="gcn")
        g = reg.gauge("repro_backlog", help="backlog")
        rng = np.random.default_rng(4)
        for i in range(300):
            wh.record(float(rng.gamma(2.0, 0.004)))
            c.inc()
            g.set(i % 7)
            if i % 50 == 49:
                clk.advance(1.3)
        reg.counter_fn("repro_hits_total", lambda: 42, help="hits")
        return reg.collect()

    def test_same_observations_same_wire(self):
        assert self._observe(
            __import__("repro_torch.obs.metrics",
                       fromlist=["MetricsRegistry"])) \
            == self._observe(j_metrics)

    def test_render_wire_same_text(self):
        wire = self._observe(j_metrics)
        merged = merge_wire([wire, inject_labels(wire, model="m1")])
        for w in (wire, merged):
            text = render_wire(w)
            assert text == j_promexp.render_wire(w)
            assert validate_exposition(text) == []
            assert j_promexp.validate_exposition(text) == []


def test_metered_server_scrape_over_http(graph):
    """A GNNServer with a telemetry port, an inproc lane and a local one:
    the scrape over loopback HTTP validates, carries the graph host's
    series (cluster scrape), the request histogram and model labels."""
    sc = _sc(telemetry=TelemetryConfig(port=0, window_s=5.0))
    srv = GNNServer(config=sc)
    srv.register("gcn", graph=graph, cfg=_cfg(graph),
                 config=_sc(transport="inproc", telemetry=sc.telemetry))
    srv.register("sage", graph=graph, cfg=_cfg(graph, "sage"), config=sc)
    srv.start()
    try:
        reqs = [srv.submit(int(t), model=m) for m in ("gcn", "sage")
                for t in range(16)]
        srv.drain(reqs, timeout=120)
        with urllib.request.urlopen(srv.metrics_url, timeout=10) as r:
            body = r.read().decode()
        rep = srv.report()
    finally:
        srv.stop()
        for m in srv.models:
            srv.engine_for(m).close()
    assert srv.metrics_url is None
    assert validate_exposition(body) == []
    assert series_count(srv.metrics_wire()) >= 20
    for fam in ("repro_host_select_seconds", "repro_rpc_calls_total",
                "repro_request_seconds"):
        assert f"# TYPE {fam} " in body
    assert 'model="gcn"' in body and 'model="sage"' in body
    assert rep["models"]["gcn"]["rpc"]["calls"] >= 4
    assert "rpc" not in rep["models"]["sage"]
    assert rep["models"]["sage"]["telemetry"]["counters"][
        "repro_batches_total"] >= 4


def test_torch_metrics_smoke_script_on_the_cpu():
    """scripts/torch_metrics_smoke.py end to end in a subprocess: serve,
    scrape the endpoint, validate, at least MIN_SERIES series."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(root / "scripts" / "torch_metrics_smoke.py"),
         "--device", "cpu", "--impl", "torch"], capture_output=True,
        text=True, timeout=300, cwd=str(root), env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "exposition valid" in out.stdout
    assert out.stdout.rstrip().endswith("metrics smoke: ok")
    assert "repro_host_select_seconds" in out.stdout
