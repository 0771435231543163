"""The work arithmetic of ``step_mfu_pct`` and the kernel rooflines at
known shapes, and the readers over a synthetic record."""
import pytest

from portbench import spec
from portbench.devtrace import DeviceTrace
from portbench.peaks import HBM_BYTES_S, TF32_FLOP_S
from portbench.record import Record

C, N, F = 512, 256, 256


def test_fused_call_work_at_the_serving_shapes():
    fused = spec.reader("fused_gnn_roofline")
    ops, byts = fused.work(C, N, F, F, "w_neigh")
    assert ops == 2 * C * N * F * F + 2 * C * N * N * F == 34_359_738_368
    # H, W, b, mask and out, plus the fp32 adjacency
    assert byts == 4 * (C * N * F + F * F + F + C * N + C * N * F) \
        + 4 * C * N * N == 403_440_640
    assert fused.bound_s(C, N, F, F, "w_neigh") == byts / HBM_BYTES_S
    ops, byts = fused.work(C, N, 512, F, "self-only")
    assert ops == 2 * C * N * 512 * F
    assert byts == 4 * (C * N * 512 + 512 * F + F + C * N + C * N * F)
    ops2, _ = fused.work(C, N, F, F, "+w_self")
    assert ops2 == 4 * C * N * F * F + 2 * C * N * N * F


def test_gat_call_work():
    gat = spec.reader("gat_attention_roofline")
    prod, ew, byts = gat.work(C, N, F, 4)
    assert prod == 2 * C * N * N * F
    assert ew == 8 * C * 4 * N * N
    assert byts == 4 * (2 * C * N * F + 2 * C * N * 4) + 4 * C * N * N
    assert gat.bound_s(C, N, F, 4) == max(prod / TF32_FLOP_S,
                                           ew / 67e12, byts / HBM_BYTES_S)


def cfg(kind, layers=16):
    return {"reference": kind, "kind": kind, "batch_size": C,
            "receptive_field": N, "f_hidden": F, "f_in": 500,
            "n_layers": layers, "n_heads": 4}


def test_model_flops_a_batch():
    mfu = spec.reader("step_mfu_pct")
    gcn = 2 * C * N * 500 * F + 2 * C * N * N * F \
        + 15 * (2 * C * N * F * F + 2 * C * N * N * F)
    assert mfu.batch_flops(cfg("gcn")) == gcn
    gat = 2 * C * N * 500 * F + 15 * 2 * C * N * F * F \
        + 16 * (4 * C * N * F + 8 * C * 4 * N * N + 2 * C * N * N * F)
    assert mfu.batch_flops(cfg("gat")) == gat


def record(c, trace, before=None, after=None):
    base = {"batches": 0, "fused_forms": {}}
    return Record(c, {}, None, 0.0, {**base, **(before or {})},
                  {**base, **(after or {})}, trace)


def test_readers_over_a_synthetic_trace():
    c = cfg("gcn")
    # 10 batches in a 1 s window; 160 fused launches of 0.5 ms each
    ops = [("tc::fused_tf32x3_kernel", i * 1e-3, i * 1e-3 + 5e-4)
           for i in range(160)]
    launches = [("launch", 0.01 * i, 0.01 * i + 1e-4) for i in range(11)]
    t = DeviceTrace(1.0, ops + [("Memcpy HtoD (Pinned -> Device)",
                                 0.5, 0.6)], launches)
    forms = {("tf32x3", 512, "w_neigh"): 10, ("tf32x3", 256, "w_neigh"): 150}
    rec = record(c, t, after={"batches": 10, "fused_forms": forms})
    fused = spec.reader("fused_gnn_roofline")
    mean_bound = (10 * fused.bound_s(C, N, 512, F, "w_neigh")
                  + 150 * fused.bound_s(C, N, F, F, "w_neigh")) / 160
    assert spec.reader("fused_gnn_roofline").read(rec) == pytest.approx(
        100 * mean_bound / 5e-4)
    mfu = spec.reader("step_mfu_pct")
    # the 10 batches launched in [0, 0.1) s: 100 fused launches busy 50 ms
    assert mfu.read(rec) == pytest.approx(
        100 * 10 * mfu.batch_flops(c) / (0.05 * TF32_FLOP_S))
    idle = spec.reader("device_idle_pct").read(rec)
    assert idle == pytest.approx(100 * (1 - (160 * 5e-4 + 0.1)))
    assert spec.reader("gat_attention_roofline").read(rec) is None


def test_readers_find_nothing_without_a_trace():
    rec = record(cfg("gcn"), None, after={"batches": 3})
    for name in ("fused_gnn_roofline", "gat_attention_roofline",
                 "step_mfu_pct", "device_idle_pct", "kernel_us_per_target",
                 "kernel_ms_per_batch"):
        assert spec.reader(name).read(rec) is None


def test_kernel_time_a_target_counts_whole_batches_between_launches():
    """Three launches a second apart, each batch 10 ms of kernels and 2 ms
    of copies; copies are left out, and a batch's work before the first
    launch and the last batch's after the last launch fall outside."""
    ops, spans = [("k", 0.3, 0.32)], []
    for i in range(3):
        t0 = 0.5 + i
        spans.append(("launch", t0, t0 + 0.001))
        ops += [("Memcpy HtoD (Pinned -> Device)", t0 + 0.001, t0 + 0.003),
                ("k", t0 + 0.003, t0 + 0.013)]
    t = DeviceTrace(3.0, ops, spans)
    rec = record(cfg("gcn"), t, before={"served": 0, "lane_batches": 0},
                 after={"served": 1024, "lane_batches": 2})
    got = spec.reader("kernel_us_per_target").read(rec)
    assert got == pytest.approx(1e6 * 2 * 0.010 / (2 * 512))
    assert spec.reader("kernel_ms_per_batch").read(rec) == pytest.approx(
        10.0)
    mfu = spec.reader("step_mfu_pct")
    assert mfu.read(rec) == pytest.approx(
        100 * 2 * mfu.batch_flops(cfg("gcn")) / (0.020 * TF32_FLOP_S))
    one = record(cfg("gcn"), DeviceTrace(3.0, ops, spans[:1]),
                 before={"served": 0, "lane_batches": 0},
                 after={"served": 512, "lane_batches": 1})
    assert spec.reader("kernel_us_per_target").read(one) is None
    assert mfu.read(one) is None
    assert spec.reader("kernel_ms_per_batch").read(one) is None
