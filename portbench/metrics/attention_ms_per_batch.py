"""Milliseconds a traced batch's attention steps held the card's stream
(each layer's scores, softmax and its tail: the ``gpu.attention`` spans,
CUDA events around them) closed in the window, over the batches (one
``gpu.tail`` a batch). None off CUDA and for models without attention."""
from portbench.progtrace import readings, snapshot, total_delta  # noqa: F401


def read(rec):
    got = readings(rec, "attention_ms_per_batch")
    if got is None:
        return None
    batches, _ = total_delta(*got, "gpu.tail")
    n, attn_s = total_delta(*got, "gpu.attention")
    return 1e3 * attn_s / batches if batches > 0 and n > 0 else None
