"""SLO burn-rate evaluation and the regression watchdog (the PyTorch
package's copy of ``repro.obs.slo``).

An SLO is a target over a rolling horizon ("99.9% of batches under
50 ms"); the *error budget* is the allowed bad fraction (0.1%). The
*burn rate* is how fast traffic is spending that budget: observed bad
fraction divided by the budget, so burn 1.0 exhausts the budget exactly
at the horizon and burn 14.4 exhausts a 30-day budget in ~2 days. We
follow the multi-window, multi-burn-rate alerting recipe (Google SRE
workbook): a breach fires only when BOTH a short and a long window
exceed the threshold — the short window makes alerts fast to clear when
the problem stops, the long window keeps one latency spike from paging
anyone.

Windows here are the ``WindowedHistogram`` ring: the short window is
the current + newest closed window (~1-2 window_s of traffic), the long
window is everything retained (windows * window_s). Both are lossless
merges, so the fractions are exact in bucket units.

``Watchdog`` is the unconditional companion (no objectives needed): it
compares the newest window against the metric's own recent history and
emits events on p99 drift, cache-hit-rate collapse, and monotone
refresh-backlog growth. Host-quarantine events are emitted at the
source (``HostPool``) — the watchdog only has to summarize them.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.hist import LogHistogram

# (name, short windows, long windows, burn threshold, severity):
# fast burn — page-worthy — vs slow burn — ticket-worthy.
BURN_POLICIES = (("fast", 1, None, 14.4, "crit"),
                 ("slow", 2, None, 6.0, "warn"))


@dataclass(frozen=True)
class SLObjective:
    """One service-level objective, evaluated against a windowed
    histogram (latency) or a pair of counters (error rate).

    kind="latency":    bad event = sample above ``threshold_s`` in
                       ``metric`` (a histogram family, selected by
                       ``labels``)
    kind="error_rate": bad fraction = bad_metric / (metric + bad_metric)
                       deltas between evaluations

    ``target`` is the success objective (0.999 → 0.1% error budget).
    """
    name: str
    metric: str = "repro_batch_seconds"
    kind: str = "latency"
    threshold_s: float = 0.050
    target: float = 0.999
    labels: Tuple[Tuple[str, str], ...] = ()
    bad_metric: str = "repro_batch_errors_total"
    good_metric: str = "repro_batches_total"

    def __post_init__(self):
        if self.kind not in ("latency", "error_rate"):
            raise ValueError("kind must be 'latency' or 'error_rate'")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.kind == "latency" and self.threshold_s <= 0:
            raise ValueError("threshold_s must be > 0")
        if not isinstance(self.labels, tuple):
            object.__setattr__(self, "labels", tuple(self.labels))

    @property
    def budget(self) -> float:
        return 1.0 - self.target


class SLOTracker:
    """Evaluates the configured objectives against the registry;
    breaches land in the event ring (crit for fast burn, warn for
    slow). One tracker per Telemetry hub."""

    def __init__(self, config, registry, events):
        self.config = config
        self.registry = registry
        self.events = events
        # error-rate objectives need deltas: snapshot counters per eval
        self._counter_marks: Dict[str, Tuple[float, float]] = {}
        self._short_marks: Dict[str, Tuple[float, float]] = {}

    # -- per-kind bad fractions ----------------------------------------------
    def _latency_fractions(self, o: SLObjective):
        wh = self.registry.get_series(o.metric, **dict(o.labels))
        if wh is None:
            return None
        merged: Dict[int, LogHistogram] = {}

        def frac(windows: Optional[int]) -> Tuple[float, int]:
            h = merged.get(-1 if windows is None else windows)
            if h is None:
                h = wh.merged(windows)
                merged[-1 if windows is None else windows] = h
            return wh_frac(h, o.threshold_s), h.count

        return frac

    def _error_fractions(self, o: SLObjective):
        def counter_value(name: str) -> float:
            m = self.registry.get_series(name, **dict(o.labels))
            return float(m.value) if m is not None else 0.0

        bad = counter_value(o.bad_metric)
        good = counter_value(o.good_metric)
        prev_long = self._counter_marks.get(o.name)
        prev_short = self._short_marks.get(o.name, (bad, good))
        # long window: lifetime-so-far until enough evals accumulate
        base = prev_long if prev_long is not None else (0.0, 0.0)

        def frac_pair(prev: Tuple[float, float]) -> Tuple[float, int]:
            d_bad = max(0.0, bad - prev[0])
            d_tot = max(0.0, good - prev[1])
            return (d_bad / d_tot if d_tot else 0.0), int(d_tot)

        short = frac_pair(prev_short)
        long_ = frac_pair(base)
        self._short_marks[o.name] = (bad, good)
        if prev_long is None:
            self._counter_marks[o.name] = (0.0, 0.0)

        def frac(windows: Optional[int]) -> Tuple[float, int]:
            return short if windows is not None else long_

        return frac

    def evaluate(self) -> List[dict]:
        rows: List[dict] = []
        for o in self.config.slos:
            frac = (self._latency_fractions(o) if o.kind == "latency"
                    else self._error_fractions(o))
            if frac is None:
                rows.append({"name": o.name, "status": "no_data"})
                continue
            burns = {}
            breach: Optional[Tuple[str, str, float]] = None
            for policy, short_w, long_w, bar, severity in BURN_POLICIES:
                f_short, n_short = frac(short_w)
                f_long, n_long = frac(long_w)
                b_short = f_short / o.budget
                b_long = f_long / o.budget
                burns[policy] = {"short": round(b_short, 4),
                                 "long": round(b_long, 4),
                                 "threshold": bar}
                enough = min(n_short, n_long) >= self.config.min_samples
                if enough and b_short > bar and b_long > bar \
                        and breach is None:
                    breach = (policy, severity, max(b_short, b_long))
            row = {"name": o.name, "kind": o.kind,
                   "target": o.target, "budget": o.budget,
                   "burn": burns,
                   "status": "breach" if breach else "ok"}
            if o.kind == "latency":
                row["threshold_s"] = o.threshold_s
            rows.append(row)
            if breach:
                policy, severity, worst = breach
                self.events.emit(
                    "slo_breach", severity=severity,
                    message=f"SLO {o.name}: {policy} burn "
                            f"{worst:.1f}x budget",
                    slo=o.name, policy=policy,
                    burn=round(worst, 4), budget=o.budget)
        return rows


def wh_frac(h: LogHistogram, threshold: float) -> float:
    return h.fraction_above(threshold)


class Watchdog:
    """Objective-free regression detection: each check compares the
    newest data against the metric's own retained history.

    p99 drift            newest closed window's p99 above
                         ``p99_drift_factor`` x the median p99 of the
                         older closed windows (every histogram family)
    cache-hit collapse   windowed hit rate below ``hit_floor_ratio`` x
                         lifetime hit rate, for every counter pair
                         following the ``*_hits_total``/``*_misses_total``
                         naming convention
    backlog growth       any ``*_backlog`` gauge strictly increasing
                         for ``backlog_growth_checks`` consecutive
                         checks

    Detections emit warn events; repeated detections of the same kind on
    the same metric are debounced (one event per episode, re-armed when
    the condition clears).
    """

    def __init__(self, config, registry, events):
        self.config = config
        self.registry = registry
        self.events = events
        self.checks = 0
        self._active: Dict[Tuple[str, str], bool] = {}
        self._hit_marks: Dict[str, Tuple[float, float]] = {}
        self._backlog_hist: Dict[str, List[float]] = {}
        self._fired: Dict[str, int] = {}

    def _fire(self, key: Tuple[str, str], message: str, **data):
        if self._active.get(key):
            return                       # still in the same episode
        self._active[key] = True
        self._fired[key[0]] = self._fired.get(key[0], 0) + 1
        self.events.emit(key[0], severity="warn", message=message,
                         metric=key[1], **data)

    def _clear(self, key: Tuple[str, str]):
        self._active[key] = False

    # -- individual checks ---------------------------------------------------
    def _check_p99_drift(self, wire_families: Dict[str, dict]):
        cfg = self.config
        for name, fam in wire_families.items():
            if fam["type"] != "histogram":
                continue
            for items, wh in fam["series"].items():
                label = name if not items else \
                    name + "{" + ",".join(f"{k}={v}"
                                          for k, v in items) + "}"
                key = ("p99_regression", label)
                p99s = wh.window_quantiles(0.99)
                counts = wh.window_counts()
                lineage = [(p, c) for p, c in zip(p99s, counts)
                           if c >= cfg.min_samples]
                if len(lineage) < 2:
                    continue
                *base, (newest_p99, _) = lineage
                baseline = statistics.median(p for p, _ in base)
                if baseline > 0 and \
                        newest_p99 > cfg.p99_drift_factor * baseline:
                    self._fire(key,
                               f"p99 of {label} drifted to "
                               f"{newest_p99 * 1e3:.2f} ms "
                               f"({newest_p99 / baseline:.1f}x the "
                               f"recent baseline)",
                               p99=newest_p99, baseline=baseline,
                               factor=round(newest_p99 / baseline, 2))
                else:
                    self._clear(key)

    def _check_hit_collapse(self, wire_families: Dict[str, dict]):
        cfg = self.config

        def series_sum(name: str) -> Optional[float]:
            fam = wire_families.get(name)
            if fam is None or fam["type"] != "counter":
                return None
            total = 0.0
            for m in fam["series"].values():
                try:
                    total += float(m.value)
                except Exception:
                    return None
            return total

        for name in list(wire_families):
            if not name.endswith("_hits_total"):
                continue
            miss_name = name[:-len("_hits_total")] + "_misses_total"
            hits = series_sum(name)
            misses = series_sum(miss_name)
            if hits is None or misses is None:
                continue
            key = ("cache_hit_collapse", name)
            prev = self._hit_marks.get(name, (0.0, 0.0))
            self._hit_marks[name] = (hits, misses)
            d_h, d_m = hits - prev[0], misses - prev[1]
            window_n = d_h + d_m
            lifetime_n = hits + misses
            if window_n < cfg.min_samples or lifetime_n <= 0:
                continue
            window_rate = d_h / window_n
            lifetime_rate = hits / lifetime_n
            if lifetime_rate > 0 and \
                    window_rate < cfg.hit_floor_ratio * lifetime_rate:
                self._fire(key,
                           f"hit rate of {name} collapsed to "
                           f"{window_rate:.1%} (lifetime "
                           f"{lifetime_rate:.1%})",
                           window_rate=round(window_rate, 4),
                           lifetime_rate=round(lifetime_rate, 4))
            else:
                self._clear(key)

    def _check_backlog_growth(self, wire_families: Dict[str, dict]):
        cfg = self.config
        for name, fam in wire_families.items():
            if fam["type"] != "gauge" or not name.endswith("_backlog"):
                continue
            level = 0.0
            for m in fam["series"].values():
                try:
                    level += float(m.value)
                except Exception:
                    break
            hist = self._backlog_hist.setdefault(name, [])
            hist.append(level)
            del hist[:-(cfg.backlog_growth_checks + 1)]
            key = ("backlog_growth", name)
            if len(hist) > cfg.backlog_growth_checks and \
                    all(b > a for a, b in zip(hist, hist[1:])):
                self._fire(key,
                           f"{name} grew for "
                           f"{cfg.backlog_growth_checks} consecutive "
                           f"checks (now {level:g})",
                           level=level, history=list(hist))
            else:
                self._clear(key)

    def check(self) -> dict:
        """Run every detector once; returns a summary of this check."""
        self.checks += 1
        with self.registry._lock:
            fams = {n: {"type": f["type"],
                        "series": dict(f["series"])}
                    for n, f in self.registry._families.items()}
        self._check_p99_drift(fams)
        self._check_hit_collapse(fams)
        self._check_backlog_growth(fams)
        return self.summary()

    def summary(self) -> dict:
        return {"checks": self.checks,
                "fired": dict(self._fired),
                "active": sorted(f"{k}:{m}" for (k, m), on
                                 in self._active.items() if on)}


__all__ = ["SLObjective", "SLOTracker", "Watchdog", "BURN_POLICIES"]
