"""The traced window: ``torch.profiler`` over the measured window, reduced
to the device's operations (kernels, copies, sets) on the host clock of
the window, the time the device was busy (the union of their intervals),
and the device's idle gaps named by what the host was doing meanwhile
(the harness's own spans around the program's stages)."""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

MARK = "portbench.clock"


@dataclass
class DeviceTrace:
    """Device operations (short name, start s, end s) clipped to the
    window [0, window_s] (seconds from the window's start), and host spans
    (label, start s, end s) on the same clock."""
    window_s: float
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]] = field(default_factory=list)

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals, sorted."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def busy_s_between(self, a: float, b: float) -> float:
        """Seconds of [a, b) in which the device was busy."""
        return sum(max(0.0, min(e, b) - max(s, a)) for s, e in self.busy())

    def kernels(self) -> "DeviceTrace":
        """The same window with the kernels alone (no copies or sets)."""
        return DeviceTrace(self.window_s,
                           [o for o in self.ops if not is_copy(o[0])],
                           self.spans)

    def launch_span(self) -> Optional[Tuple[float, float, int]]:
        """(first, last, k): the starts of the window's first and last
        batch launch (the host spans labelled "launch") and the k batches
        launched from the first up to the last; None with fewer than two
        launches. The device work of those k batches lies in [first,
        last) as long as each finishes before the next launch."""
        starts = sorted(s for label, s, _ in self.spans if label == "launch")
        if len(starts) < 2:
            return None
        return starts[0], starts[-1], len(starts) - 1

    def by_name(self, pattern: str) -> Tuple[int, float]:
        """(count, total seconds) of the operations whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.ops if rx.search(n)]
        return len(hits), sum(hits)

    def top_ops(self, k: int = 10) -> List[List[object]]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            tot[n] += e - s
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List[object]]:
        """Idle seconds summed by what the host was doing: each gap
        between busy intervals goes to the host span label that covers
        most of it ("host_other" where no span does)."""
        busy = self.busy()
        edges = [0.0] + [x for iv in busy for x in iv] + [self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        by_label: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for label, s, e in self.spans:
            by_label[label].append((s, e))
        unions = {}
        for label, ivs in by_label.items():
            merged: List[List[float]] = []
            for s, e in sorted(ivs):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            unions[label] = ([m[0] for m in merged], merged)
        tot: Dict[str, float] = defaultdict(float)
        for gs, ge in gaps:
            best, cover = "host_other", 0.0
            for label, (starts, merged) in unions.items():
                c = 0.0
                i = max(0, bisect.bisect_right(starts, gs) - 1)
                while i < len(merged) and merged[i][0] < ge:
                    c += max(0.0, min(ge, merged[i][1])
                             - max(gs, merged[i][0]))
                    i += 1
                if c > cover:
                    best, cover = label, c
            tot["idle_while." + best] += ge - gs
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda x: -x[1])[:k]]


def is_copy(name: str) -> bool:
    """Whether a device operation is a copy or a set, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def short_name(name: str) -> str:
    """A device operation's name without return type, template arguments,
    anonymous namespace and parameters (copies and sets keep theirs), at
    most 64 characters."""
    if is_copy(name):
        return name[:64]
    depth, out = 0, []
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split()
    return (words[-1] if words else name)[:64]


class Profiled:
    """``with Profiled() as p: ...`` profiles the block; ``p.mark()`` ties
    the profiler's clock to ``time.perf_counter`` (call it inside)."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._mark_ns: Optional[int] = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def mark(self) -> None:
        with torch.profiler.record_function(MARK):
            self._mark_ns = time.perf_counter_ns()

    def reduce(self, t0: float, t_close: float,
               spans: List[Tuple[str, int, int]]) -> DeviceTrace:
        """The device's operations and the host spans in the window
        [t0, t_close] (perf_counter seconds)."""
        events = self.prof.profiler.kineto_results.events()
        offset = None
        for e in events:
            if e.name() == MARK:
                offset = e.start_ns() - self._mark_ns
                break
        if offset is None:
            raise RuntimeError("profiler trace holds no clock mark")
        base = t0 * 1e9
        win = t_close - t0
        ops = []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = (e.start_ns() - offset - base) / 1e9
            end = s + e.duration_ns() / 1e9
            s, end = max(s, 0.0), min(end, win)
            if end > s:
                ops.append((short_name(e.name()), s, end))
        hs = []
        for label, a, b in spans:
            s, end = max((a - base) / 1e9, 0.0), min((b - base) / 1e9, win)
            if end > s:
                hs.append((label, s, end))
        return DeviceTrace(win, ops, hs)
