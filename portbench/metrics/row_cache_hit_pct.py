"""Build's subgraph-row cache: hits over lookups of the window's batches
(``SchedulerStats.build_hits`` / ``build_misses``, unique targets a
batch)."""


def read(rec):
    hits, misses = rec.delta("build_hits"), rec.delta("build_misses")
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
