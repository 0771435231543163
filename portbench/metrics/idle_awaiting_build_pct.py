"""Share of the card's idle time spent waiting for a batch that stood in
Build (queued for it or in it), from the first traced
``dispatch.wait_host`` span of the window to its last: the program's
critical-path account of the idle time (``progtrace.idle_by_station``),
beside the harness's ``idle_while.*`` gaps, which go to whatever stage
ran meanwhile. Idle time from torch.profiler's trace; the station from
the awaited batch's own ``select`` and ``build`` spans."""
from portbench.progtrace import idle_by_station, snapshot  # noqa: F401


def read(rec):
    idle = idle_by_station(rec, "idle_awaiting_build_pct")
    if idle is None:
        return None
    total = sum(idle.values())
    return 100.0 * idle["build"] / total if total > 0 else None
