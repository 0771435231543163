"""Data pipelines: synthetic token stream for LM training and a
target-vertex stream for GNN inference — both with background prefetch and
straggler mitigation (the paper's host-side overlap, generalized).

A copy of the reference's ``repro.data.pipeline`` (numpy only), so that
this package never imports ``repro``: ``synthetic_batch`` draws bitwise
the reference's batches. Token batches are deterministic functions of
(seed, step) so training is reproducible and restart-safe: after
checkpoint restore at step k the pipeline resumes at batch k with no state
file. ``PrefetchIterator.close()`` stops and joins its worker thread.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefetch: int = 2
    # straggler mitigation: if a produce takes > straggler_timeout x the
    # trailing mean, the batch is produced from the fallback fast path
    straggler_timeout: float = 10.0


def synthetic_batch(cfg: TokenPipelineConfig, step: int
                    ) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens: deterministic in (seed, step)."""
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    b, s = cfg.global_batch, cfg.seq_len
    base = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
    # inject local structure so loss decreases measurably when training:
    # token t+1 := (token t + delta) mod V on half the positions
    delta = rng.integers(1, 17, size=(b, 1), dtype=np.int32)
    structured = (base[:, :-1] + delta) % cfg.vocab_size
    mask = rng.random((b, s - 1)) < 0.5
    tokens = base.copy()
    tokens[:, 1:] = np.where(mask, structured, base[:, 1:])
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels}


class PrefetchIterator:
    """Background-thread prefetch with straggler skip.

    produce(step) runs in a worker; if it stalls beyond the straggler
    budget the consumer synthesizes the batch inline (deterministic, so the
    skipped worker result is simply discarded on arrival).
    """

    def __init__(self, produce, prefetch: int = 2,
                 straggler_timeout_s: Optional[float] = None):
        self.produce = produce
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.straggler_timeout_s = straggler_timeout_s
        self._stop = threading.Event()
        self._step = 0
        self._consumed = 0
        self.stragglers_skipped = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            batch = self.produce(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        want = self._consumed
        tmo = self.straggler_timeout_s
        try:
            step, batch = self.q.get(timeout=tmo) if tmo else self.q.get()
            while step < want:      # stale (already skipped) batches
                step, batch = self.q.get(timeout=tmo) if tmo \
                    else self.q.get()
        except queue.Empty:
            self.stragglers_skipped += 1
            batch = self.produce(want)      # inline fallback
        self._consumed = want + 1
        return batch

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def token_pipeline(cfg: TokenPipelineConfig) -> PrefetchIterator:
    return PrefetchIterator(lambda step: synthetic_batch(cfg, step),
                            prefetch=cfg.prefetch)


def target_vertex_stream(num_vertices: int, batch: int, seed: int = 0):
    """Endless stream of target-vertex batches for GNN serving."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, num_vertices, size=batch, dtype=np.int64)
