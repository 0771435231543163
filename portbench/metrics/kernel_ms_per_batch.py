"""Card kernel time a batch, in milliseconds: the seconds in which a
kernel ran on the card (copies and sets left out) from the window's first
batch launch to its last, over the batches launched in that span. The
padded fixed-shape step alone: ``kernel_us_per_target`` without the
batches' fill."""


def read(rec):
    t = rec.trace
    span = t.launch_span() if t is not None and t.ops else None
    if span is None:
        return None
    a, b, k = span
    return 1e3 * t.kernels().busy_s_between(a, b) / k
