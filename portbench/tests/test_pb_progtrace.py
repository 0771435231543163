"""The readers of the program's own tracer (``portbench/progtrace.py``)
over synthetic records, and a tiny traced run on the CPU in which every
host reader reads."""
import pytest

from portbench import progtrace, spec
from portbench.devtrace import DeviceTrace
from portbench.load import Window
from portbench.record import Record

HOST = ("queue_wait_ms", "select_ms_per_batch", "build_ms_per_batch",
        "pack_ms_per_batch", "kernel_build_s")
DEVICE = ("device_layers_ms_per_batch", "attention_ms_per_batch",
          "idle_awaiting_build_pct")
W0 = 1000.0           # the window's start on perf_counter's clock


def reading(totals=None, spans=(), dropped=0, queue=(0.0, 0), build=None):
    return {"totals": totals or {}, "dropped": dropped, "spans": list(spans),
            "queue_wait_s": queue[0], "n_admitted": queue[1],
            "build": build or {"built": 0, "built_s": 0.0, "loaded": 0,
                               "loaded_s": 0.0},
            "gpu_anchor_rtt_us": None}


def record(before, after, trace=None):
    names = HOST + DEVICE
    return Record({}, {}, Window([], W0, W0 + 10.0), 0.0,
                  {n: before for n in names}, {n: after for n in names},
                  trace)


def read(name, rec):
    return spec.reader(name).read(rec)


def batch(trace_id, select, build, pack, root=True):
    """A traced batch's station spans (seconds), with its root when it
    finished."""
    spans = [{"name": k, "trace_id": trace_id, "t0": 0.0, "dur": v}
             for k, v in (("select", select), ("build", build),
                          ("pack", pack))]
    if root:
        spans.append({"name": "batch", "trace_id": trace_id, "t0": 0.0,
                      "dur": 5.0})
    return spans


EARLIER = batch(1, 9.0, 9.0, 9.0)       # finished before the open
OPEN = reading(
    totals={"select": (2, 0.2, 0.2), "build": (2, 2.0, 2.0),
            "pack": (1, 0.3, 0.3)},
    spans=EARLIER, queue=(1.0, 100),
    build={"built": 4, "built_s": 9.5, "loaded": 4, "loaded_s": 0.25})
CLOSE = reading(
    totals={"select": (12, 1.2, 1.2), "build": (11, 11.0, 11.0),
            "pack": (11, 3.3, 3.3), "gpu.layer": (160, 1.6, 1.6),
            "gpu.tail": (10, 0.01, 0.01), "gpu.attention": (160, 1.2, 1.2),
            "batch": (10, 20.0, 5.0)},
    # two batches finished in the window; a late span of one that has not
    spans=EARLIER + batch(2, 0.05, 0.9, 0.2) + batch(3, 0.15, 1.1, 0.4)
    + batch(4, 7.0, 7.0, 7.0, root=False),
    queue=(4.0, 1100),
    build={"built": 4, "built_s": 9.5, "loaded": 4, "loaded_s": 0.25})


def test_host_readers():
    rec = record(OPEN, CLOSE)
    assert read("queue_wait_ms", rec) == pytest.approx(3.0)
    # the stations of the batches that finished in the window, over them
    assert read("select_ms_per_batch", rec) == pytest.approx(100.0)
    assert read("build_ms_per_batch", rec) == pytest.approx(1000.0)
    assert read("pack_ms_per_batch", rec) == pytest.approx(300.0)
    assert read("kernel_build_s", rec) == pytest.approx(9.75)


def test_device_step_readers():
    rec = record(OPEN, CLOSE)
    assert read("device_layers_ms_per_batch", rec) == pytest.approx(161.0)
    assert read("attention_ms_per_batch", rec) == pytest.approx(120.0)


def test_dropped_spans_or_no_program_read_nothing():
    lost = dict(CLOSE, dropped=3)
    for name in HOST + DEVICE:
        assert read(name, record(OPEN, lost)) is None
        assert read(name, record(None, None)) is None


def test_no_device_spans_read_nothing():
    cpu = reading(totals={k: CLOSE["totals"][k]
                          for k in ("select", "build", "pack")},
                  spans=CLOSE["spans"], queue=(4.0, 1100))
    rec = record(OPEN, cpu)
    for name in DEVICE:
        assert read(name, rec) is None
    assert read("build_ms_per_batch", rec) == pytest.approx(1000.0)


def span(name, trace_id, s, e):
    """A span at [s, e] seconds of the window, on the tracer's clock."""
    from repro_torch.obs.trace import from_perf_counter
    t0 = from_perf_counter(W0 + s)
    return {"name": name, "trace_id": trace_id, "t0": t0,
            "dur": from_perf_counter(W0 + e) - t0}


def test_snapshot_reads_the_tracer_once_at_each_end():
    """Every metric's ``snapshot`` gets one reading at the open and one at
    the close, though the server admits requests between their calls."""
    from types import SimpleNamespace
    pytest.importorskip("torch")
    from repro_torch.obs import TraceConfig, Tracer
    tracer = Tracer(TraceConfig())
    attached = []

    def attach_tracer(config):
        attached.append(config)
        return tracer
    class System:       # weakly referenced, like the harness's
        pass
    stats = SimpleNamespace(queue_wait_s=0.0, n_admitted=5)
    system = System()
    system.engine = SimpleNamespace(attach_tracer=attach_tracer)
    system.server = SimpleNamespace(stats=stats)
    opened = [progtrace.snapshot(system) for _ in range(3)]
    assert opened[0]["n_admitted"] == 5
    assert all(r is opened[0] for r in opened)
    closed = []
    for _ in range(3):
        stats.n_admitted += 4
        stats.queue_wait_s += 1.0
        closed.append(progtrace.snapshot(system))
    assert closed[0]["n_admitted"] == 9 and closed[0]["queue_wait_s"] == 1.0
    assert all(r is closed[0] for r in closed)
    assert attached[0].ring_capacity == progtrace.RING


def test_idle_goes_to_the_station_of_the_awaited_batch():
    # the card works [0, 1], [5, 6] and [9.6, 10]
    trace = DeviceTrace(10.0, [("k", 0.0, 1.0), ("k", 5.0, 6.0),
                               ("k", 9.6, 10.0)])
    spans = [
        # batch 1, awaited over [1, 5]: in Build until 3, then Pack
        span("select", 1, -2.0, 0.5), span("build", 1, 0.5, 3.0),
        span("pack", 1, 3.0, 5.0), span("dispatch.wait_host", 1, 1.0, 5.0),
        # batch 2, awaited over [6.5, 9.5]: Select until 7, queued for
        # Build and in it until 8.5, then Pack
        span("select", 2, 4.0, 7.0), span("build", 2, 7.5, 8.5),
        span("pack", 2, 8.5, 9.5), span("dispatch.wait_host", 2, 6.5, 9.5),
        # a wait whose batch's stations were not kept
        span("dispatch.wait_host", 3, 9.5, 9.75)]
    got = progtrace.idle_by_station(
        record(OPEN, reading(spans=spans), trace), "idle_awaiting_build_pct")
    # idle in [1, 9.75]: [1, 5], [6, 9.6]; [6, 6.5] outside any wait,
    # [9.5, 9.6] in the wait for batch 3
    assert got == pytest.approx({"select": 0.5, "build": 2.0 + 1.5,
                                 "pack": 2.0 + 1.0, "other": 0.5 + 0.1},
                                abs=1e-6)
    pct = read("idle_awaiting_build_pct",
               record(OPEN, reading(spans=spans), trace))
    assert pct == pytest.approx(100.0 * 3.5 / 7.6, abs=1e-4)


def test_idle_reader_needs_waits_and_a_trace():
    trace = DeviceTrace(10.0, [("k", 0.0, 1.0)])
    assert read("idle_awaiting_build_pct",
                record(OPEN, reading(), trace)) is None
    spans = [span("dispatch.wait_host", 1, 1.0, 5.0)]
    assert read("idle_awaiting_build_pct",
                record(OPEN, reading(spans=spans), None)) is None


def test_idle_gaps_between_busy_intervals():
    busy = [(0.0, 1.0), (2.0, 3.0), (5.0, 8.0)]
    assert progtrace.idle_gaps(busy, 0.5, 6.0) == [(1.0, 2.0), (3.0, 5.0)]
    assert progtrace.idle_gaps(busy, 0.0, 10.0) == [(1.0, 2.0), (3.0, 5.0),
                                                    (8.0, 10.0)]


def test_tiny_traced_run_reads_every_host_metric():
    from tiny import run_tiny
    result, _, _ = run_tiny("gcn-l16-c512-zipf-closed", trace=True,
                            seconds=2.0)
    got = result["metrics"]
    for name in HOST:
        assert name in got, name
    for name in DEVICE:       # the card's spans and trace only
        assert name not in got, name
    assert result["correct"]
    stages = sum(got[n]["value"] for n in ("select_ms_per_batch",
                                           "build_ms_per_batch",
                                           "pack_ms_per_batch"))
    assert stages == pytest.approx(got["host_stages_ms"]["value"], rel=0.5)
