"""The load generator: one thread that draws every request from the seed
and sends it through a ``submit(target)`` call, in a closed or an open
loop, as a traffic file says.

Traffic file keys: ``loop`` ("closed" | "open"), ``zipf_a`` (the skew
over popularity ranks), ``support`` (how many of the top-ranked vertices
the targets are drawn from; null: every vertex, as the port's
``zipf_traffic`` draws), ``fill`` (set-up serves that many of the
top-ranked vertices once, coldest first, so the caches start near their
steady state), ``clients`` (closed: requests outstanding; each is a slot
that sends again when its answer comes) and ``rate_per_s`` (open:
Poisson arrivals). Every request is timed on this thread's clock from
when it was due to when the generator saw its answer.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

DRAWS = 1 << 21          # closed-loop targets drawn a run (cycled)
POLL_S = 2e-4            # the drain's sleep between looks after the close
WAKE_CAP_S = 0.05        # the longest wait on ``wake`` before a fresh look
DRAIN_S = 60.0           # how long answers are waited for after the close


@dataclass
class Sent:
    """One request: its target, when it was due, sent and answered (0.0:
    no answer) on ``time.perf_counter``'s clock, and the program's
    request object."""
    target: int
    t_due: float
    t_sent: float
    t_seen: float = 0.0
    req: object = None

    @property
    def latency_s(self) -> float:
        return self.t_seen - self.t_due


@dataclass
class Window:
    sent: List[Sent]
    t0: float
    t_close: float

    @property
    def seconds(self) -> float:
        return self.t_close - self.t0

    def answered_in_window(self) -> List[Sent]:
        return [s for s in self.sent if 0.0 < s.t_seen <= self.t_close]


def zipf_targets(ws: np.ndarray, a: float, count: int,
                 rng: np.random.Generator) -> np.ndarray:
    """``count`` targets drawn Zipf(a) over the ranks of ``ws`` (hottest
    first): with the same generator and ``ws`` every vertex by rank, the
    draws of ``zipf_traffic``."""
    p = 1.0 / np.arange(1, len(ws) + 1, dtype=np.float64) ** a
    return ws[rng.choice(len(ws), size=count, p=p / p.sum())]


def plan(traffic: dict, ranked: np.ndarray, seed: int, seconds: float):
    """(targets, due offsets or None) of one run, from the seed alone, drawn
    over ``ranked`` (the support, hottest first)."""
    rng = np.random.default_rng([seed, 7])
    if traffic["loop"] == "closed":
        return zipf_targets(ranked, traffic["zipf_a"], DRAWS, rng), None
    rate = float(traffic["rate_per_s"])
    gaps = rng.exponential(1.0 / rate, size=int(rate * seconds * 1.5) + 64)
    due = np.cumsum(gaps)
    due = due[due < seconds]
    return zipf_targets(ranked, traffic["zipf_a"], len(due), rng), due


def _done(req) -> bool:
    return req.t_done != 0.0 or req.error is not None


def _reap(live: deque, now: float) -> int:
    """Stamp the answered requests at the head of ``live`` (answers come
    in the order sent); returns how many."""
    n = 0
    while live and _done(live[0].req):
        live.popleft().t_seen = now
        n += 1
    return n


def _drain(live: deque, deadline: float) -> None:
    while live and time.perf_counter() < deadline:
        if not _reap(live, time.perf_counter()):
            time.sleep(POLL_S)
    # answered out of order, or never: stamp what came, leave the rest
    now = time.perf_counter()
    for s in live:
        if _done(s.req):
            s.t_seen = now


def run(submit: Callable[[int], object], traffic: dict,
        targets: np.ndarray, due: Optional[np.ndarray], seconds: float,
        wake: threading.Event,
        on_close: Callable[[], None] = lambda: None) -> Window:
    """Drive one measured window of ``seconds``, call ``on_close`` as it
    closes, then wait for the answers still outstanding (at most
    ``DRAIN_S``). The server sets ``wake`` each time answers come; the
    generator clears it before each look and, with nothing to do, waits
    on it (at most ``WAKE_CAP_S``), which keeps it off the interpreter's
    lock while the server works."""
    sent: List[Sent] = []
    live: deque = deque()
    t0 = time.perf_counter()
    close = t0 + seconds

    def send(i: int, t_due: float, now: float):
        s = Sent(int(targets[i % len(targets)]), t_due, now)
        s.req = submit(s.target)
        sent.append(s)
        live.append(s)

    if traffic["loop"] == "closed":
        for i in range(int(traffic["clients"])):
            send(i, t0, t0)
        i = len(sent)
        while True:
            wake.clear()
            now = time.perf_counter()
            if now >= close:
                break
            n = _reap(live, now)
            for _ in range(n):          # each answered client sends again
                t = time.perf_counter()
                send(i, t, t)
                i += 1
            if not n:
                left = close - time.perf_counter()
                wake.wait(min(WAKE_CAP_S, max(0.0, left)))
    else:
        i = 0
        while True:
            wake.clear()
            now = time.perf_counter()
            while i < len(due) and t0 + due[i] <= now:
                send(i, t0 + due[i], time.perf_counter())
                i += 1
            _reap(live, now)
            if i >= len(due) and now >= close:
                break
            nxt = t0 + due[i] if i < len(due) else close
            left = nxt - time.perf_counter()
            wake.wait(min(WAKE_CAP_S, max(0.0, left)))
    on_close()
    _drain(live, close + DRAIN_S)
    return Window(sent, t0, close)
