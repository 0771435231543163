"""The GraphSAGE cell's pieces: the plain reference against a hand-worked
mean, its operation count, and the three readers the cell adds
(``sg_aggregate_roofline``, ``aggregate_ms_per_batch``, ``edge_fill_pct``)
over synthetic records, including a program that has none of their
counters or spans (they read nothing and do not raise)."""
import pytest
import torch

from portbench import spec
from portbench.devtrace import DeviceTrace
from portbench.peaks import HBM_BYTES_S
from portbench.record import Record
from portbench.reference import sage

C, N, F = 512, 256, 256


def test_mean_over_real_neighbours_without_self():
    """Vertex 0 has neighbours 1 and 2, vertex 1 has 0, vertex 2 none:
    its mean is 0, and its own features enter through W_self alone."""
    a = torch.tensor([[[0., 1., 1.], [1., 0., 0.], [0., 0., 0.]]])
    x = torch.tensor([[[1., 0.], [0., 2.], [4., 4.]]])
    eye = torch.eye(2)
    params = {"layer0": {"w_self": eye, "w_neigh": 10 * eye,
                         "b": torch.zeros(2)}}
    cfg = {"n_layers": 1}
    mask = torch.tensor([[1., 1., 1.]])
    h = sage.mean_adjacency(a) @ x
    assert torch.equal(h, torch.tensor([[[2., 3.], [1., 0.], [0., 0.]]]))
    got = sage.forward(cfg, params, x, a, mask)
    # rows: [21, 30], [10, 2], [4, 4]; the max readout over them
    assert torch.equal(got, torch.tensor([[21., 30.]]))


def test_layer_flops_and_shapes():
    assert sage.layer_flops({}, C, N, 500, F) == \
        2 * C * N * N * 500 + 4 * C * N * 500 * F
    assert sage.param_shapes({}, 500, F) == {
        "w_self": ((500, F), 500), "w_neigh": ((500, F), 500),
        "b": ((F,), 0)}


def test_sg_call_work():
    roof = spec.reader("sg_aggregate_roofline")
    ops, byts = roof.work(C, N, 12288, F)
    assert ops == 2 * C * 12288 * F
    # src, dst and w [C, E]; h read once and out written once [C, N, F]
    assert byts == 3 * 4 * C * 12288 + 2 * 4 * C * N * F
    assert roof.bound_s(C, N, 12288, F) == byts / HBM_BYTES_S


def record(trace, before, after):
    return Record({}, {}, None, 0.0, before, after, trace)


def test_sg_roofline_over_a_synthetic_trace():
    """32 sort launches of 0.4 ms (16 at F=512 and 16 at F=256) and the
    counters' shapes; every kernel of a bucket launch counts toward its
    time, one kernel of it toward the count."""
    roof = spec.reader("sg_aggregate_roofline")
    ops = [("void scatter_gather_kernel<float, 4>", i * 1e-3,
            i * 1e-3 + 4e-4) for i in range(32)]
    shapes = {("sort", C, N, 12288, 512): 16, ("sort", C, N, 12288, F): 16}
    rec = record(DeviceTrace(1.0, ops),
                 {"sg_aggregate_roofline": {}},
                 {"sg_aggregate_roofline": shapes})
    mean_bound = (roof.bound_s(C, N, 12288, 512)
                  + roof.bound_s(C, N, 12288, F)) / 2
    assert roof.read(rec) == pytest.approx(100 * mean_bound / 4e-4)
    bucket = [(f"void bucket_{k}_kernel", 0.1, 0.1 + 1e-4)
              for k in ("count", "scan", "place", "gather")]
    rec = record(DeviceTrace(1.0, bucket),
                 {"sg_aggregate_roofline": {}},
                 {"sg_aggregate_roofline": {("bucket", 8, 1024, 74496, F):
                                            1}})
    assert roof.read(rec) == pytest.approx(
        100 * roof.bound_s(8, 1024, 74496, F) / 4e-4)


def test_edge_fill_and_aggregate_spans():
    fill = spec.reader("edge_fill_pct")
    rec = record(None, {"edge_fill_pct": {"edges": 10, "slots": 100}},
                 {"edge_fill_pct": {"edges": 4510, "slots": 10100}})
    assert fill.read(rec) == pytest.approx(45.0)
    agg = spec.reader("aggregate_ms_per_batch")
    reading = {"dropped": 0, "totals": {}}
    closed = {"dropped": 0, "totals": {"gpu.tail": (4, 0.004, 0.0),
                                       "gpu.aggregate": (64, 0.024, 0.0)}}
    rec = record(None, {"aggregate_ms_per_batch": reading},
                 {"aggregate_ms_per_batch": closed})
    assert agg.read(rec) == pytest.approx(6.0)


def test_a_program_without_the_counters_reads_nothing():
    """The parent side: no shape counter, no edge counters, no
    ``gpu.aggregate`` span. The snapshots give None and the readers
    None."""
    class Stats:
        pass

    class System:
        engine = type("E", (), {"scheduler": type("S", (), {
            "stats": Stats()})()})()

    assert spec.reader("edge_fill_pct").snapshot(System()) is None
    none = {"sg_aggregate_roofline": None, "edge_fill_pct": None,
            "aggregate_ms_per_batch": None}
    rec = record(DeviceTrace(1.0, []), none, none)
    for name in none:
        assert spec.reader(name).read(rec) is None
    empty = {"dropped": 0, "totals": {"gpu.tail": (4, 0.004, 0.0)}}
    rec = record(None, {"aggregate_ms_per_batch": empty},
                 {"aggregate_ms_per_batch": empty})
    assert spec.reader("aggregate_ms_per_batch").read(rec) is None


@pytest.mark.gpu
def test_program_passes_and_control_fails_on_the_sage_cell():
    """On a card, at ``test_pb_control.py``'s small size: the sage cell's
    comparison passes the program and fails its TF32 control."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import run
    from portbench.control import control_gap
    from portbench.tests.test_pb_control import SMALL
    got = {}

    def also(window, graph, cfg, params, device, seed):
        got["control"] = control_gap(window, graph, cfg, params, device,
                                     seed)
        got["limit"] = cfg["check"]["limits"]["emb_gap"]

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        result, _, checks = run.run_cell("sage-sg-l16-c512-zipf-closed",
                                         seed, 1.0, False, overrides=SMALL,
                                         also=also)
        assert result["correct"], {c.name: c.value for c in checks}
        assert got["control"] > got["limit"], got
