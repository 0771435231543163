"""Host time of Select + Build + Pack a batch, in ms: the scheduler's
per-stage totals (``SchedulerStats.stage_times``) over the window's
batches."""


def read(rec):
    batches = rec.delta("batches")
    if batches <= 0:
        return None
    return 1e3 * rec.stage_delta_s() / batches
