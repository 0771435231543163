"""Flight recorder: full span trees for the K slowest batches (a copy of
``repro.obs.flight``).

The export ring in the tracer is a sliding window — great for "what just
happened", useless for "why was batch 4182 slow twenty minutes ago". The
flight recorder answers the second question in bounded memory: it keeps
the complete span trees (with cache/RPC annotations) of exactly the K
slowest batches seen so far, evicting the fastest of the retained set
when a slower one arrives. K is small (default 8) and each tree is a few
dozen dicts, so the footprint is O(K), independent of batch count.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import List, Optional


class FlightRecorder:
    """Bounded keep-the-K-slowest store of batch span trees.

    A min-heap on duration makes ``offer`` O(log K): the root is the
    fastest retained batch, so a new batch either beats it (replace) or
    is dropped. The monotonic tiebreak counter keeps equal durations
    FIFO and the heap comparison away from dict payloads.
    """

    def __init__(self, k: int = 8):
        self.k = int(k)
        self._heap: List[tuple] = []     # (dur, tick, entry-dict)
        self._tick = itertools.count()
        self._lock = threading.Lock()
        self.offered = 0
        self.kept = 0

    def offer(self, trace_id: int, dur: float, spans: List[dict],
              meta: Optional[dict] = None) -> bool:
        """Consider one finished batch; returns True iff retained."""
        if self.k == 0:
            return False
        entry = {"trace_id": int(trace_id), "dur": float(dur),
                 "spans": list(spans), "meta": dict(meta or {})}
        with self._lock:
            self.offered += 1
            if len(self._heap) < self.k:
                heapq.heappush(self._heap,
                               (entry["dur"], next(self._tick), entry))
                self.kept += 1
                return True
            if entry["dur"] > self._heap[0][0]:
                heapq.heapreplace(self._heap,
                                  (entry["dur"], next(self._tick), entry))
                self.kept += 1
                return True
            return False

    def entries(self) -> List[dict]:
        """Retained batches, slowest first."""
        with self._lock:
            items = sorted(self._heap, key=lambda t: -t[0])
        return [e for _, _, e in items]

    def summary(self) -> dict:
        """Report-sized view: per-batch duration + span count, no trees."""
        with self._lock:
            items = sorted(self._heap, key=lambda t: -t[0])
        return {"k": self.k, "offered": self.offered,
                "retained": len(items),
                "slowest": [{"trace_id": e["trace_id"],
                             "dur": round(e["dur"], 6),
                             "spans": len(e["spans"]),
                             "meta": e["meta"]}
                            for _, _, e in items]}

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


__all__ = ["FlightRecorder"]
