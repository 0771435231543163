"""The load generator: seeded traffic, its Zipf shape, and the closed and
open loops' client counts and due times."""
import queue
import threading
import time

import numpy as np

from portbench import load

WS = np.arange(1000, 3048)[::-1].copy()      # a support of 2048, hottest first


def test_seeded_traffic_repeats_and_differs_by_seed():
    mix = {"loop": "open", "rate_per_s": 500.0, "zipf_a": 1.1}
    t1, d1 = load.plan(mix, WS, 2**31 + 3, 4.0)
    t2, d2 = load.plan(mix, WS, 2**31 + 3, 4.0)
    t3, d3 = load.plan(mix, WS, 2**31 + 4, 4.0)
    assert np.array_equal(t1, t2) and np.array_equal(d1, d2)
    assert not np.array_equal(d1, d3)
    closed = {"loop": "closed", "zipf_a": 1.1}
    c1, none = load.plan(closed, WS, 11, 4.0)
    assert none is None and np.array_equal(c1, load.plan(closed, WS, 11,
                                                         4.0)[0])


def test_zipf_shape_over_the_support():
    rng = np.random.default_rng(0)
    t = load.zipf_targets(WS, 1.1, 400_000, rng)
    assert set(np.unique(t)) <= set(WS)
    counts = {v: c for v, c in zip(*np.unique(t, return_counts=True))}
    h = (1.0 / np.arange(1, 2049) ** 1.1).sum()
    for rank in (1, 2, 10):
        want = 400_000 / rank ** 1.1 / h
        assert abs(counts[WS[rank - 1]] - want) < 5 * np.sqrt(want)
    assert counts[WS[0]] / counts[WS[1]] > 1.9     # 2 ** 1.1 = 2.14


def test_open_arrivals_are_poisson_at_the_rate():
    mix = {"loop": "open", "rate_per_s": 2000.0, "zipf_a": 1.1}
    _, due = load.plan(mix, WS, 5, 10.0)
    assert np.all(np.diff(due) > 0) and due[-1] < 10.0
    assert abs(len(due) - 20_000) < 5 * np.sqrt(20_000)
    gaps = np.diff(due)
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05   # exponential


class Req:
    def __init__(self):
        self.t_done, self.error, self.embedding = 0.0, None, None


class FakeServer:
    """Answers requests in order, a few at a time, after a short wait,
    setting ``wake`` after each answer; and keeps the most it ever had
    outstanding."""

    def __init__(self, wake, delay=0.002, batch=8):
        self.q, self.delay, self.batch = queue.Queue(), delay, batch
        self.wake = wake
        self.out = self.peak = 0
        self.lock = threading.Lock()
        self.stop = False
        self.thread = threading.Thread(target=self.serve, daemon=True)
        self.thread.start()

    def submit(self, target):
        r = Req()
        with self.lock:
            self.out += 1
            self.peak = max(self.peak, self.out)
        self.q.put(r)
        return r

    def serve(self):
        while not self.stop:
            try:
                reqs = [self.q.get(timeout=0.01)]
            except queue.Empty:
                continue
            while len(reqs) < self.batch and not self.q.empty():
                reqs.append(self.q.get())
            time.sleep(self.delay)
            with self.lock:
                self.out -= len(reqs)
            for r in reqs:
                r.t_done = time.perf_counter()
            self.wake.set()


def test_closed_loop_keeps_its_clients():
    wake = threading.Event()
    srv = FakeServer(wake)
    try:
        mix = {"loop": "closed", "clients": 32, "zipf_a": 1.1}
        targets, _ = load.plan(mix, WS, 1, 0.5)
        w = load.run(srv.submit, mix, targets, None, 0.5, wake)
    finally:
        srv.stop = True
        srv.thread.join(5)
    assert srv.peak == 32
    assert len(w.answered_in_window()) > 32
    assert all(s.t_seen > 0 for s in w.sent)
    # each request after the first 32 was sent when an answer came
    assert len(w.sent) - 32 <= len(w.answered_in_window())
    assert [s.target for s in w.sent] == list(targets[:len(w.sent)])


def test_open_loop_sends_each_request_at_its_due_time():
    wake = threading.Event()
    srv = FakeServer(wake)
    try:
        mix = {"loop": "open", "rate_per_s": 400.0, "zipf_a": 1.1}
        targets, due = load.plan(mix, WS, 3, 1.0)
        w = load.run(srv.submit, mix, targets, due, 1.0, wake)
    finally:
        srv.stop = True
        srv.thread.join(5)
    assert len(w.sent) == len(due)
    assert np.allclose([s.t_due - w.t0 for s in w.sent], due)
    assert all(s.t_sent >= s.t_due for s in w.sent)
    late = np.array([s.t_sent - s.t_due for s in w.sent])
    assert np.median(late) < 0.01
    assert all(s.latency_s > 0 for s in w.sent)
