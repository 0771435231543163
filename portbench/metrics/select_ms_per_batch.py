"""Host milliseconds a traced batch spent in Select: the program's ``select``
station spans of the batches that finished in the window, over the count
of those batches (``progtrace.mean_ms``), the set of batches
``host_stages_ms`` averages over."""
from portbench.progtrace import mean_ms, snapshot  # noqa: F401


def read(rec):
    return mean_ms(rec, "select_ms_per_batch", "select")
