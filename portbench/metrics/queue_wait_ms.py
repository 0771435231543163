"""Milliseconds a request waited in the server before the scheduler
admitted it: in its lane's queue, while its batch formed, and in
``submit_chunk``'s wait for an in-flight slot. The server's own counters
(``ServerStats.queue_wait_s`` over ``n_admitted``), read at the window's
open and close (``progtrace.snapshot``)."""
from portbench.progtrace import readings, snapshot  # noqa: F401


def read(rec):
    got = readings(rec, "queue_wait_ms")
    if got is None:
        return None
    a, b = got
    n = b["n_admitted"] - a["n_admitted"]
    return 1e3 * (b["queue_wait_s"] - a["queue_wait_s"]) / n if n > 0 \
        else None
