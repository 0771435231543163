"""Streaming log-bucketed histograms + a fixed-size reservoir.

The PyTorch package's own copy of ``repro.obs.hist`` (numpy only): the
same buckets, the same arithmetic, so both packages read the same
quantiles off the same records.

The serving stack used to keep every per-request latency in an unbounded
Python list — fine for a benchmark, a slow leak for a server that handles
millions of requests. ``LogHistogram`` is the HDR-histogram idea in fixed
memory: geometric buckets with ``2**(1/16)`` growth (~2.2% bucket width),
so any quantile read off the bucket counts is within ~±2.2% of the true
value while memory stays a few hundred int64 counters regardless of how
many samples were recorded. Count/sum/min/max are tracked exactly, so
``mean`` has no bucket error at all.

``Reservoir`` is the companion raw-sample window: the last ``capacity``
values verbatim (recent forensics — exact values for the newest traffic),
also O(1) in stream length.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional

import numpy as np

# bucket boundaries: value_floor * GROWTH**i ; 16 buckets per doubling
_BUCKETS_PER_DOUBLING = 16
_LOG2_SCALE = float(_BUCKETS_PER_DOUBLING)


class LogHistogram:
    """Fixed-memory streaming histogram over (0, +inf) with bounded
    relative error per bucket.

    ``value_floor`` is the resolution floor: everything at or below it
    lands in bucket 0 (default 1 microsecond — nothing in this codebase
    times shorter). Values above ``value_ceil`` clamp into the last
    bucket. ``quantile`` returns the geometric midpoint of the bucket
    holding the q-th sample — deterministic, exact in bucket units.
    """

    __slots__ = ("value_floor", "counts", "count", "total", "min", "max")

    def __init__(self, value_floor: float = 1e-6,
                 value_ceil: float = 4096.0):
        if value_floor <= 0 or value_ceil <= value_floor:
            raise ValueError("need 0 < value_floor < value_ceil")
        self.value_floor = float(value_floor)
        n = int(math.ceil(math.log2(value_ceil / value_floor)
                          * _LOG2_SCALE)) + 2
        self.counts = np.zeros(n, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def _index(self, value: float) -> int:
        if value <= self.value_floor:
            return 0
        i = int(math.log2(value / self.value_floor) * _LOG2_SCALE) + 1
        return min(i, len(self.counts) - 1)

    def _bucket_value(self, i: int) -> float:
        """Geometric midpoint of bucket ``i`` (the quantile estimate)."""
        if i == 0:
            return self.value_floor
        return self.value_floor * 2.0 ** ((i - 0.5) / _LOG2_SCALE)

    def record(self, value: float) -> None:
        v = float(value)
        if v < 0 or v != v:               # negatives/NaN never count
            return
        self.counts[self._index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q in [0, 1]; returns 0.0 for an empty histogram. Clamped to
        the exact observed [min, max] so the bucket-midpoint estimate
        never leaves the data's true range."""
        if self.count == 0:
            return 0.0
        rank = min(self.count - 1, int(q * self.count))
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank + 1))
        return float(min(max(self._bucket_value(i), self.min), self.max))

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def fraction_above(self, threshold: float) -> float:
        """Fraction of recorded samples strictly above ``threshold``,
        read off the bucket counts (a sample in the threshold's own
        bucket counts by its geometric midpoint, so the answer is exact
        up to one ~2.2% bucket). This is the SLO tracker's "bad event"
        fraction for latency objectives."""
        if self.count == 0:
            return 0.0
        t = float(threshold)
        above = sum(int(self.counts[i])
                    for i in np.nonzero(self.counts)[0]
                    if self._bucket_value(int(i)) > t)
        return above / self.count

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        if other.value_floor != self.value_floor or \
                len(other.counts) != len(self.counts):
            raise ValueError("cannot merge histograms with different "
                             "bucket schemes")
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def to_dict(self) -> dict:
        """Sparse serialization: only non-empty buckets, keyed by index,
        plus the scheme (floor + growth) needed to reconstruct bounds."""
        nz = np.nonzero(self.counts)[0]
        return {"scheme": "log2", "buckets_per_doubling":
                _BUCKETS_PER_DOUBLING,
                "value_floor": self.value_floor,
                "count": int(self.count),
                "mean": round(self.mean, 9),
                "min": 0.0 if self.count == 0 else round(self.min, 9),
                "max": round(self.max, 9),
                **{k: round(v, 9) for k, v in self.percentiles().items()},
                "counts": {int(i): int(self.counts[i]) for i in nz}}

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        """Inverse of ``to_dict``: rebuild a histogram from its sparse
        serialization (bucket counts restore exactly, so quantiles are
        bit-identical; ``total`` is recovered as mean*count). Accepts
        string bucket keys — JSON round-trips turn int keys into str."""
        if d.get("scheme") != "log2":
            raise ValueError(f"unknown histogram scheme {d.get('scheme')!r}")
        if d.get("buckets_per_doubling") != _BUCKETS_PER_DOUBLING:
            raise ValueError(
                f"bucket scheme mismatch: serialized "
                f"{d.get('buckets_per_doubling')} buckets/doubling vs "
                f"this build's {_BUCKETS_PER_DOUBLING}")
        h = cls(value_floor=float(d.get("value_floor", 1e-6)))
        for i, c in (d.get("counts") or {}).items():
            h.counts[min(int(i), len(h.counts) - 1)] += int(c)
        h.count = int(d.get("count", 0))
        h.total = float(d.get("mean", 0.0)) * h.count
        if h.count:
            h.min = float(d.get("min", 0.0))
            h.max = float(d.get("max", 0.0))
        return h

    @property
    def nbytes(self) -> int:
        """Fixed memory footprint (the O(1)-in-samples property)."""
        return int(self.counts.nbytes)


class Reservoir:
    """Last-``capacity`` raw values, O(1) memory in stream length."""

    __slots__ = ("_buf",)

    def __init__(self, capacity: int = 256):
        self._buf: deque = deque(maxlen=int(capacity))

    def record(self, value: float) -> None:
        self._buf.append(float(value))

    def values(self) -> list:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def capacity(self) -> int:
        return self._buf.maxlen


def merge_hist_dicts(a: Optional[dict], b: Optional[dict]) -> dict:
    """Losslessly merge two ``LogHistogram.to_dict()`` payloads (bucket
    counts add, count/min/max/mean combine exactly, quantiles recompute
    from the merged counts). This is how per-host histograms from a
    cluster metrics scrape fold into one view: merged count equals the
    sum of the per-host counts by construction. Bucket schemes must
    match (same floor + growth); JSON round-trips may have stringified
    the bucket keys, both spellings are accepted."""
    if not a:
        return dict(b or {})
    if not b:
        return dict(a)
    if a.get("value_floor") != b.get("value_floor") or \
            a.get("buckets_per_doubling") != b.get("buckets_per_doubling"):
        raise ValueError("cannot merge histograms with different "
                         "bucket schemes")
    counts: Dict[int, int] = {}
    for d in (a, b):
        for k, v in (d.get("counts") or {}).items():
            counts[int(k)] = counts.get(int(k), 0) + int(v)
    ca, cb = int(a.get("count", 0)), int(b.get("count", 0))
    n = ca + cb
    mean = (a.get("mean", 0.0) * ca + b.get("mean", 0.0) * cb) / n \
        if n else 0.0
    out = {"scheme": "log2",
           "buckets_per_doubling": a.get("buckets_per_doubling",
                                         _BUCKETS_PER_DOUBLING),
           "value_floor": a["value_floor"], "count": n,
           "mean": round(mean, 9),
           "min": min(a.get("min", math.inf), b.get("min", math.inf))
           if n else 0.0,
           "max": max(a.get("max", 0.0), b.get("max", 0.0)),
           "counts": {k: counts[k] for k in sorted(counts)}}
    for name, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
        v = hist_dict_quantile(out, q)
        out[name] = round(v, 9) if v is not None else 0.0
    return out


def hist_dict_quantile(d: dict, q: float) -> Optional[float]:
    """Read a quantile back out of a ``LogHistogram.to_dict()`` payload
    (export-side tooling works on serialized histograms)."""
    counts = d.get("counts") or {}
    total = sum(counts.values())
    if not total:
        return None
    floor = d["value_floor"]
    per = d.get("buckets_per_doubling", _BUCKETS_PER_DOUBLING)
    rank = min(total - 1, int(q * total))
    cum = 0
    for i in sorted(int(k) for k in counts):
        cum += counts[i]
        if cum > rank:
            v = floor if i == 0 else floor * 2.0 ** ((i - 0.5) / per)
            return min(max(v, d.get("min", v)), d.get("max", v))
    return None


__all__ = ["LogHistogram", "Reservoir", "hist_dict_quantile",
           "merge_hist_dicts"]
