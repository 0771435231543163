"""Host milliseconds a traced batch spent in Pack: the program's ``pack``
station spans of the batches that finished in the window, over the count
of those batches (``progtrace.mean_ms``), the set of batches
``host_stages_ms`` averages over."""
from portbench.progtrace import mean_ms, snapshot  # noqa: F401


def read(rec):
    return mean_ms(rec, "pack_ms_per_batch", "pack")
