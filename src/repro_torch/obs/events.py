"""Bounded structured event ring — the telemetry plane's alert channel
(the PyTorch package's copy of ``repro.obs.events``).

Watchdog detections (p99 drift, cache-hit collapse, refresh-backlog
growth), SLO burn-rate breaches, and host-quarantine notices all land
here as plain-dict events: a fixed-capacity ring (old events roll off,
evictions counted) that serving never blocks on and reports surface
verbatim. Events are JSON-scalar trees only, so they cross the wire
codec and land in ``telemetry.*`` report sections unchanged.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from repro_torch.obs.trace import now

SEVERITIES = ("info", "warn", "crit")


class EventRing:
    """Thread-safe bounded ring of structured events.

    ``emit`` never blocks and never raises on serving paths; when the
    ring is full the oldest event is dropped (counted in ``dropped``).
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.emitted = 0
        self.dropped = 0
        self.by_severity: Dict[str, int] = {s: 0 for s in SEVERITIES}

    def emit(self, kind: str, severity: str = "info",
             message: str = "", **data) -> dict:
        """Record one event; returns the event dict (already ringed)."""
        if severity not in SEVERITIES:
            raise ValueError(
                f"severity={severity!r}, expected one of {SEVERITIES}")
        with self._lock:
            ev = {"seq": self._seq, "t": now(), "kind": str(kind),
                  "severity": severity, "message": str(message),
                  "data": dict(data)}
            self._seq += 1
            self.emitted += 1
            self.by_severity[severity] += 1
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
        return ev

    def snapshot(self, limit: Optional[int] = None,
                 kind: Optional[str] = None,
                 min_severity: str = "info") -> List[dict]:
        """Newest-last copy of the retained events, optionally filtered
        by kind and minimum severity."""
        floor = SEVERITIES.index(min_severity)
        with self._lock:
            evs = list(self._ring)
        evs = [e for e in evs
               if SEVERITIES.index(e["severity"]) >= floor
               and (kind is None or e["kind"] == kind)]
        return evs[-limit:] if limit else evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def summary(self, recent: int = 16) -> dict:
        """The ``telemetry.events`` report slice: counters + the newest
        ``recent`` events verbatim."""
        with self._lock:
            counts = dict(self.by_severity)
            emitted, dropped = self.emitted, self.dropped
            tail = list(self._ring)[-recent:]
        return {"emitted": emitted, "dropped": dropped,
                "capacity": self.capacity, "by_severity": counts,
                "recent": tail}


__all__ = ["EventRing", "SEVERITIES"]
