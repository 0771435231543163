"""The traced window's reduction: busy time, idle gaps by host activity,
device operation names."""
from portbench.devtrace import DeviceTrace, short_name


def test_busy_is_the_union_of_the_operations():
    t = DeviceTrace(10.0, [("k", 1.0, 2.0), ("k", 1.5, 3.0),
                           ("copy", 5.0, 6.0), ("k", 5.5, 5.7)])
    assert t.busy() == [(1.0, 3.0), (5.0, 6.0)]
    assert abs(t.busy_s - 3.0) < 1e-12
    count, total = t.by_name(r"^k$")
    assert count == 3 and abs(total - 2.7) < 1e-12
    assert abs(t.busy_s_between(2.5, 5.5) - 1.0) < 1e-12
    assert t.busy_s_between(3.0, 5.0) == 0.0


def test_idle_gaps_go_to_the_host_span_that_covers_them():
    t = DeviceTrace(10.0, [("k", 1.0, 3.0), ("k", 5.0, 6.0)],
                    [("pack", 3.0, 4.8), ("launch", 4.8, 5.0),
                     ("pack", 6.0, 9.0)])
    gaps = dict(t.idle_gaps())
    # [0,1] nothing; [3,5] pack 1.8 of 2; [6,10] pack 3 of 4
    assert abs(gaps["idle_while.host_other"] - 1.0) < 1e-12
    assert abs(gaps["idle_while.pack"] - 6.0) < 1e-12
    assert abs(sum(gaps.values()) - (10.0 - t.busy_s)) < 1e-12


def test_top_ops_sum_by_name():
    t = DeviceTrace(5.0, [("a", 0, 1), ("b", 1, 3), ("a", 3, 3.5)])
    assert t.top_ops() == [["b", 2], ["a", 1.5]]


def test_short_names():
    assert short_name("void tc::fused_tf32x3_kernel<3, true>(CUtensorMap_st"
                      ", float const*)") == "tc::fused_tf32x3_kernel"
    assert short_name("Memcpy HtoD (Pinned -> Device)") \
        == "Memcpy HtoD (Pinned -> Device)"
    assert short_name("(anonymous namespace)::tc::fused_tf32x3_kernel<true, "
                      "false>(CUtensorMap_st, float)") \
        == "tc::fused_tf32x3_kernel"
    assert short_name("std::enable_if<!T7, void>::type internal::gemvx::"
                      "kernel<int, float>(float)") == "internal::gemvx::kernel"
    assert len(short_name("x" * 200)) == 64
