"""Milliseconds a traced batch's layers and tail held the card's stream:
the program's ``gpu.layer`` and ``gpu.tail`` spans (CUDA events recorded
on the serving stream between the program's layers, so launch gaps
inside the step count) closed in the window, over their batches (one
``gpu.tail`` a batch). None off CUDA: the spans exist on a card only."""
from portbench.progtrace import readings, snapshot, total_delta  # noqa: F401


def read(rec):
    got = readings(rec, "device_layers_ms_per_batch")
    if got is None:
        return None
    batches, tail_s = total_delta(*got, "gpu.tail")
    _, layers_s = total_delta(*got, "gpu.layer")
    return 1e3 * (layers_s + tail_s) / batches if batches > 0 else None
