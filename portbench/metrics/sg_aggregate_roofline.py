"""``scatter_gather_aggregate`` (kernels/scatter_gather.py) against its
roofline: the mean bytes bound of the window's launches over their mean
time on the card.

One call: src, dst [C, E] int32 and w [C, E] float32, h [C, N, F] read
once, out [C, N, F] written once (the sort kernel writes all N rows). Its
operations, 2 F a live edge, are counted here at every one of the E slots
(the counter gives shapes, not live edges): an upper bound that the kernel,
which skips the weight-0 padding, does not run, so the bound is the bytes
over HBM bandwidth. Shapes from the program's ``shape_launches`` counter
((variant, C, N, E, F) -> launches); the time from the profiler's trace:
every kernel of a launch (the sort kernel's one, or the bucket variant's
count, scan, place and gather), over the launches (one sort or gather
kernel each)."""
from portbench.peaks import HBM_BYTES_S

KERNELS = r"scatter_gather_kernel|bucket_(count|scan|place|gather)_kernel"
ONE_A_LAUNCH = r"scatter_gather_kernel|bucket_gather_kernel"


def work(c, n, e, f, elem=4):
    """(operations at every edge slot, bytes) of one call."""
    ops = 2.0 * c * e * f
    byts = 3 * c * e * 4 + 2 * c * n * f * elem
    return ops, byts


def bound_s(c, n, e, f):
    return work(c, n, e, f)[1] / HBM_BYTES_S


def snapshot(system):
    from repro_torch.kernels import scatter_gather
    got = getattr(scatter_gather, "shape_launches", None)
    return None if got is None else dict(got)


def read(rec):
    b = rec.before.get("sg_aggregate_roofline")
    a = rec.after.get("sg_aggregate_roofline")
    if rec.trace is None or a is None or b is None:
        return None
    calls = {k: v - b.get(k, 0) for k, v in a.items() if v - b.get(k, 0)}
    count, _ = rec.trace.by_name(ONE_A_LAUNCH)
    _, seconds = rec.trace.by_name(KERNELS)
    if not count or not calls:
        return None
    total = sum(calls.values())
    mean_bound = sum(k_n * bound_s(c, n, e, f)
                     for (_, c, n, e, f), k_n in calls.items()) / total
    return 100.0 * mean_bound / (seconds / count)
