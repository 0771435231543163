"""Milliseconds a traced batch's scatter-gather Aggregates held the card's
stream (the ``gpu.aggregate`` spans, CUDA events around each sg Aggregate)
closed in the window, over the batches (one ``gpu.tail`` a batch). None
off CUDA, for programs without an sg Aggregate and for a program that
records no such span."""
from portbench.progtrace import readings, snapshot, total_delta  # noqa: F401


def read(rec):
    got = readings(rec, "aggregate_ms_per_batch")
    if got is None:
        return None
    batches, _ = total_delta(*got, "gpu.tail")
    n, agg_s = total_delta(*got, "gpu.aggregate")
    return 1e3 * agg_s / batches if batches > 0 and n > 0 else None
