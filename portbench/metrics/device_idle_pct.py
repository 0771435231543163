"""Share of the traced window in which no kernel, copy or set ran on the
card: 100 x (1 - union of the device's operation intervals / window),
from torch.profiler's trace."""


def read(rec):
    t = rec.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
