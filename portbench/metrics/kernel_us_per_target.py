"""Card kernel time a served target costs, in microseconds: the seconds in
which a kernel ran on the card (the union of the kernels' intervals, from
torch.profiler; copies and sets left out) from the window's first batch
launch to its last, over the targets of the batches launched in that span
(each batch's real targets: the lane's served count over its batch count
in the window). What a target costs the card's SMs, whatever host feeds
the card."""


def read(rec):
    t = rec.trace
    span = t.launch_span() if t is not None and t.ops else None
    if span is None or rec.delta("lane_batches") <= 0:
        return None
    a, b, k = span
    per_batch = rec.delta("served") / rec.delta("lane_batches")
    return 1e6 * t.kernels().busy_s_between(a, b) / (k * per_batch)
