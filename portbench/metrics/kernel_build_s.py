"""Seconds the process spent building (``nvcc``) and loading the port's
CUDA kernel libraries before the window opened (``kernels.build.stats``:
the wall time of the build calls plus the loads), a part of ``setup_s``:
about ten seconds on a run that builds, well under one on a run that
finds them built."""
from portbench.progtrace import readings, snapshot  # noqa: F401


def read(rec):
    got = readings(rec, "kernel_build_s")
    if got is None:
        return None
    b = got[0]["build"]
    return b["built_s"] + b["loaded_s"]
