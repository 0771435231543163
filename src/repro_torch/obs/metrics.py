"""Live telemetry plane: windowed time-series metrics for the serving
stack (the PyTorch package's copy of ``repro.obs.metrics``, numpy only).

The tracer answers "what happened to THAT batch"; this module answers
"what has been happening for the last five minutes" — the continuous
signal an operator watches while the deployment serves. Three metric
kinds, all fixed-memory:

  * ``Counter``    — monotonic totals (requests, cache hits, retries).
    Collect-time *callback* counters (``counter_fn``) read an existing
    subsystem counter (cache ``hits``, tier ``demotions``) with ZERO
    hot-path cost: nothing is incremented twice, the registry samples
    the source at scrape time.
  * ``Gauge``      — point-in-time levels (refresh backlog, resident
    rows), set directly or via collect-time callback.
  * ``WindowedHistogram`` — a ring of ``LogHistogram`` windows rotated
    every ``window_s`` seconds plus a lifetime total. The ring gives
    sliding-window quantiles ("p99 over the last 5 minutes") with
    LOSSLESS merge — window histograms share one bucket scheme, so
    merging k windows is bucket-count addition, bitwise the histogram
    of their union of samples.

``MetricsRegistry`` owns the metric families; ``collect()`` serializes
them to a plain JSON tree (the *wire form*) that crosses the RPC codec
for cluster-wide scrape, merges losslessly across hosts
(``merge_wire``), and renders to Prometheus text (obs.promexp).

``Telemetry`` is the per-deployment hub the engine owns when
``ServingConfig(telemetry=TelemetryConfig(...))`` is set: registry +
bounded event ring + SLO tracker + regression watchdog. Telemetry is
**opt-in and zero-cost when off** — with ``telemetry=None`` no objects
exist and every instrumentation site is a single ``is None`` test;
metrics only *count* the existing calls, so metered and unmetered runs
are bitwise-identical.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.events import EventRing
from repro_torch.obs.hist import LogHistogram, merge_hist_dicts

LabelItems = Tuple[Tuple[str, str], ...]

METRIC_TYPES = ("counter", "gauge", "histogram")


def _label_items(labels: Dict[str, str]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclass(frozen=True)
class TelemetryConfig:
    """Knobs of the telemetry plane (``ServingConfig(telemetry=...)``).

    window_s / windows   sliding-window geometry: histograms rotate a
                         fresh ``LogHistogram`` every ``window_s``
                         seconds and retain the last ``windows`` closed
                         windows (sliding horizon = windows * window_s)
    port                 HTTP exposition port for the deployment's
                         ``/metrics`` endpoint (GNNServer / graph-host
                         CLI); None = no endpoint, 0 = ephemeral
    events_capacity      bounded structured event ring size
    eval_every_s         SLO + watchdog evaluation cadence; 0 (default)
                         = lazy evaluation piggybacked on report() /
                         scrape calls, > 0 = background thread
    slos                 SLO objectives (obs.slo.SLObjective) evaluated
                         with multi-window burn rates; () = none
    watchdog             enable the regression watchdog (p99 drift,
                         cache-hit collapse, backlog growth)
    p99_drift_factor     watchdog: newest window's p99 above factor x
                         median of the older windows' p99 is a drift
    hit_floor_ratio      watchdog: windowed cache-hit rate below ratio x
                         historical rate is a collapse
    backlog_growth_checks watchdog: backlog gauge strictly growing for
                         this many consecutive checks is a leak
    min_samples          watchdog/SLO: windows with fewer samples are
                         not judged (cold starts must not page anyone)
    """
    window_s: float = 60.0
    windows: int = 5
    port: Optional[int] = None
    events_capacity: int = 256
    eval_every_s: float = 0.0
    slos: Tuple = ()
    watchdog: bool = True
    p99_drift_factor: float = 3.0
    hit_floor_ratio: float = 0.5
    backlog_growth_checks: int = 3
    min_samples: int = 8

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if self.windows < 1:
            raise ValueError("windows must be >= 1")
        if self.port is not None and not (0 <= self.port <= 65535):
            raise ValueError("port must be in [0, 65535] (or None)")
        if self.events_capacity < 1:
            raise ValueError("events_capacity must be >= 1")
        if self.eval_every_s < 0:
            raise ValueError("eval_every_s must be >= 0 (0 = lazy)")
        if self.p99_drift_factor <= 1.0:
            raise ValueError("p99_drift_factor must be > 1")
        if not 0.0 < self.hit_floor_ratio < 1.0:
            raise ValueError("hit_floor_ratio must be in (0, 1)")
        if self.backlog_growth_checks < 2:
            raise ValueError("backlog_growth_checks must be >= 2")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if not isinstance(self.slos, tuple):
            object.__setattr__(self, "slos", tuple(self.slos))
        from repro_torch.obs.slo import SLObjective
        for o in self.slos:
            if not isinstance(o, SLObjective):
                raise TypeError(
                    f"slos entries must be obs.slo.SLObjective, got "
                    f"{type(o).__name__}")

    def describe(self) -> dict:
        return {"window_s": self.window_s, "windows": self.windows,
                "port": self.port, "eval_every_s": self.eval_every_s,
                "slos": [o.name for o in self.slos],
                "watchdog": self.watchdog}


class Counter:
    """Monotonic counter (thread-safe increment)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time level; ``set`` replaces, ``add`` adjusts."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class WindowedHistogram:
    """Sliding-window latency distribution: a lifetime ``total``
    LogHistogram plus a ring of per-window histograms rotated every
    ``window_s`` seconds (lazily, on record/read — an idle metric costs
    nothing). All windows share one bucket scheme, so any subset merges
    losslessly into the exact histogram of those windows' samples."""

    __slots__ = ("window_s", "windows", "total", "_cur", "_cur_start",
                 "_ring", "_lock", "_clock")

    def __init__(self, window_s: float = 60.0, windows: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.windows = int(windows)
        self._clock = clock
        self.total = LogHistogram()
        self._cur = LogHistogram()
        self._cur_start = clock()
        self._ring: deque = deque(maxlen=self.windows)
        self._lock = threading.Lock()

    def _maybe_rotate_locked(self, now: float) -> None:
        elapsed = now - self._cur_start
        if elapsed < self.window_s:
            return
        k = min(int(elapsed // self.window_s), self.windows + 1)
        for _ in range(k):
            self._ring.append(self._cur)
            self._cur = LogHistogram()
        # re-anchor on the window grid (idle gaps produce empty windows,
        # keeping "last k windows" an honest time horizon)
        self._cur_start = now - (elapsed % self.window_s)

    def rotate(self) -> None:
        """Force-close the current window (tests / deterministic
        evaluation; production rotation is lazy on record/read)."""
        with self._lock:
            self._ring.append(self._cur)
            self._cur = LogHistogram()
            self._cur_start = self._clock()

    def record(self, value: float) -> None:
        now = self._clock()
        with self._lock:
            self._maybe_rotate_locked(now)
            self._cur.record(value)
            self.total.record(value)

    def merged(self, windows: Optional[int] = None) -> LogHistogram:
        """Lossless merge of the newest ``windows`` closed windows plus
        the current one (None = all retained) — the sliding-window view
        burn rates and drift checks read."""
        with self._lock:
            self._maybe_rotate_locked(self._clock())
            closed = list(self._ring)
            cur = self._cur
        if windows is not None:
            closed = closed[-windows:] if windows else []
        out = LogHistogram()
        for h in closed:
            out.merge(h)
        out.merge(cur)
        return out

    def window_quantiles(self, q: float = 0.99) -> List[float]:
        """Per-closed-window quantile series, oldest first (the
        watchdog's drift baseline)."""
        with self._lock:
            self._maybe_rotate_locked(self._clock())
            closed = list(self._ring)
        return [h.quantile(q) for h in closed]

    def window_counts(self) -> List[int]:
        with self._lock:
            self._maybe_rotate_locked(self._clock())
            return [h.count for h in self._ring]

    @property
    def count(self) -> int:
        return self.total.count

    def to_dict(self) -> dict:
        """Wire form: lifetime total + merged sliding window, both as
        sparse bucket payloads (mergeable across hosts)."""
        window = self.merged()
        with self._lock:
            total = self.total.to_dict()
        return {"window_s": self.window_s, "windows": self.windows,
                "total": total, "window": window.to_dict()}


class _CallbackSeries:
    """Collect-time metric: value is ``fn()`` at scrape, nothing on the
    hot path (how existing subsystem counters join the plane)."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], float]):
        self.fn = fn

    @property
    def value(self) -> float:
        return float(self.fn())


class MetricsRegistry:
    """The deployment's metric families, keyed ``name`` then label set.

    Naming follows Prometheus convention: ``repro_<subsystem>_<what>``
    with ``_total`` on counters and ``_seconds`` / ``_bytes`` units.
    ``collect()`` returns the wire form every surface shares:

        {"host": str, "families": {name: {"type", "help", "series":
            [{"labels": {...}, "value": float}                # scalar
             | {"labels": {...}, "total": hist, "window": hist}]}}}
    """

    def __init__(self, host: str = "client", *, window_s: float = 60.0,
                 windows: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.host = host
        self.window_s = float(window_s)
        self.windows = int(windows)
        self._clock = clock
        self._lock = threading.Lock()
        # name -> {"type", "help", "series": {label_items: metric}}
        self._families: Dict[str, dict] = {}

    def _get(self, name: str, mtype: str, help_: str,
             labels: Dict[str, str], factory):
        items = _label_items(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"type": mtype, "help": help_, "series": {}}
                self._families[name] = fam
            elif fam["type"] != mtype:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{fam['type']!r}, not {mtype!r}")
            m = fam["series"].get(items)
            if m is None:
                m = fam["series"][items] = factory()
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def whist(self, name: str, help: str = "",
              **labels) -> WindowedHistogram:
        return self._get(
            name, "histogram", help, labels,
            lambda: WindowedHistogram(self.window_s, self.windows,
                                      clock=self._clock))

    def counter_fn(self, name: str, fn: Callable[[], float],
                   help: str = "", **labels) -> None:
        """Register a collect-time counter reading ``fn()`` — the
        zero-hot-path spelling for counters a subsystem already keeps
        (cache hits, tier demotions, RPC retries)."""
        self._get(name, "counter", help, labels,
                  lambda: _CallbackSeries(fn))

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "", **labels) -> None:
        self._get(name, "gauge", help, labels,
                  lambda: _CallbackSeries(fn))

    def get_series(self, name: str, **labels):
        """The metric object behind one series, or None (tests, SLO and
        watchdog lookups)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam["series"].get(_label_items(labels))

    def families(self) -> Dict[str, str]:
        with self._lock:
            return {n: f["type"] for n, f in self._families.items()}

    def collect(self) -> dict:
        """Serialize every family to the wire form (JSON scalars only —
        crosses the RPC codec and merges across hosts losslessly)."""
        with self._lock:
            fams = {n: (f["type"], f["help"], dict(f["series"]))
                    for n, f in self._families.items()}
        out: Dict[str, dict] = {}
        for name, (mtype, help_, series) in sorted(fams.items()):
            rows = []
            for items, m in sorted(series.items()):
                row: dict = {"labels": {k: v for k, v in items}}
                if isinstance(m, WindowedHistogram):
                    row.update(m.to_dict())
                else:
                    try:
                        row["value"] = float(m.value)
                    except Exception:       # a dead callback must not
                        continue            # kill the scrape
                rows.append(row)
            out[name] = {"type": mtype, "help": help_, "series": rows}
        return {"host": self.host, "families": out}


# -- wire-form algebra (cluster scrape) --------------------------------------

def inject_labels(wire: dict, **labels) -> dict:
    """Return a copy of a wire form with extra labels on every series
    (``model=`` per server lane, ``graph_host=`` per scraped host)."""
    fams = {}
    for name, fam in wire.get("families", {}).items():
        rows = [dict(r, labels={**r.get("labels", {}),
                                **{k: str(v) for k, v in labels.items()}})
                for r in fam.get("series", [])]
        fams[name] = dict(fam, series=rows)
    return dict(wire, families=fams)


def merge_wire(wires: List[dict]) -> dict:
    """Merge wire forms from several registries into one cluster view:
    same-name same-labels series combine — counters and gauges add,
    histograms merge bucket counts losslessly (merged count == sum of
    per-registry counts). Families present on only some hosts pass
    through; a type conflict raises (a drifted deployment should fail
    the scrape loudly, not average apples with oranges)."""
    fams: Dict[str, dict] = {}
    hosts: List[str] = []
    for w in wires:
        if not w:
            continue
        h = w.get("host")
        if h and h not in hosts:
            hosts.append(h)
        for name, fam in w.get("families", {}).items():
            tgt = fams.get(name)
            if tgt is None:
                tgt = fams[name] = {"type": fam["type"],
                                    "help": fam.get("help", ""),
                                    "series": {}}
            elif tgt["type"] != fam["type"]:
                raise ValueError(
                    f"metric {name!r} is {tgt['type']!r} on one host "
                    f"and {fam['type']!r} on another")
            for row in fam.get("series", []):
                key = _label_items(row.get("labels", {}))
                cur = tgt["series"].get(key)
                if cur is None:
                    tgt["series"][key] = dict(row)
                elif "value" in row:
                    cur["value"] = cur.get("value", 0.0) \
                        + float(row["value"])
                else:
                    cur["total"] = merge_hist_dicts(cur.get("total"),
                                                    row.get("total"))
                    cur["window"] = merge_hist_dicts(cur.get("window"),
                                                    row.get("window"))
    out_fams = {name: dict(fam, series=[fam["series"][k]
                                        for k in sorted(fam["series"])])
                for name, fam in sorted(fams.items())}
    return {"host": ",".join(hosts) or "merged", "hosts": hosts,
            "families": out_fams}


def series_count(wire: dict) -> int:
    return sum(len(f.get("series", []))
               for f in wire.get("families", {}).values())


class Telemetry:
    """Per-deployment telemetry hub: registry + event ring + SLO
    tracker + regression watchdog (one per DecoupledEngine, or one per
    graph-host service). ``evaluate()`` runs the SLO burn-rate and
    watchdog checks; with ``eval_every_s == 0`` it is invoked lazily by
    ``report()`` (rate-limited to once per window), else a background
    thread drives it."""

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 host: str = "client",
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or TelemetryConfig()
        self.host = host
        self.registry = MetricsRegistry(
            host, window_s=self.config.window_s,
            windows=self.config.windows, clock=clock)
        self.events = EventRing(self.config.events_capacity)
        from repro_torch.obs.slo import SLOTracker, Watchdog
        self.slo = SLOTracker(self.config, self.registry, self.events) \
            if self.config.slos else None
        self.watchdog = Watchdog(self.config, self.registry,
                                 self.events) \
            if self.config.watchdog else None
        self.evaluations = 0
        self._last_eval = 0.0
        self._last_slo: List[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # pre-resolved hot-path series (scheduler feeds these per batch)
        self._h_batch = self.registry.whist(
            "repro_batch_seconds", help="end-to-end batch latency")
        self._h_stage: Dict[str, WindowedHistogram] = {}
        self._c_batches = self.registry.counter(
            "repro_batches_total", help="completed batches")
        self._c_errors = self.registry.counter(
            "repro_batch_errors_total", help="failed batches")
        if self.config.eval_every_s > 0:
            self._thread = threading.Thread(
                target=self._eval_loop, name="telemetry-eval",
                daemon=True)
            self._thread.start()

    # -- hot-path feeds ------------------------------------------------------
    def observe_batch(self, latency_s: float, stage_times: Dict[str, float],
                      error: bool = False) -> None:
        """One completed pipeline batch: end-to-end latency + per-stage
        wall split (called from the scheduler's completion path; cost is
        a handful of histogram records per BATCH, not per request)."""
        self._h_batch.record(latency_s)
        self._c_batches.inc()
        if error:
            self._c_errors.inc()
        for stage, dt in stage_times.items():
            h = self._h_stage.get(stage)
            if h is None:
                h = self._h_stage[stage] = self.registry.whist(
                    "repro_stage_seconds",
                    help="host pipeline stage wall time", stage=stage)
            h.record(dt)

    def whist(self, name: str, help: str = "",
              **labels) -> WindowedHistogram:
        return self.registry.whist(name, help=help, **labels)

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self.registry.counter(name, help=help, **labels)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self) -> dict:
        """Run SLO burn-rate + watchdog checks now; breaches and
        regressions land in the event ring. Returns the evaluation."""
        slo_rows = self.slo.evaluate() if self.slo is not None else []
        wd = self.watchdog.check() if self.watchdog is not None else None
        with self._lock:
            self.evaluations += 1
            self._last_eval = time.monotonic()
            self._last_slo = slo_rows
        return {"slo": slo_rows, "watchdog": wd}

    def _maybe_evaluate(self) -> None:
        """Lazy cadence: at most one evaluation per window when no
        background thread drives it."""
        if self.config.eval_every_s > 0:
            return
        with self._lock:
            due = time.monotonic() - self._last_eval \
                >= self.config.window_s
        if due:
            self.evaluate()

    def _eval_loop(self):
        while not self._stop.wait(self.config.eval_every_s):
            try:
                self.evaluate()
            except Exception:    # an evaluation bug must never kill
                pass             # the deployment

    # -- reporting -----------------------------------------------------------
    def to_wire(self) -> dict:
        return self.registry.collect()

    def report(self) -> dict:
        """The ``telemetry.*`` report section (versioned key map in
        core.report_schema)."""
        self._maybe_evaluate()
        wire = self.registry.collect()
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, dict] = {}
        for name, fam in wire["families"].items():
            for row in fam["series"]:
                items = _label_items(row.get("labels", {}))
                key = name if not items else \
                    name + "{" + ",".join(f"{k}={v}"
                                          for k, v in items) + "}"
                if fam["type"] == "counter":
                    counters[key] = row["value"]
                elif fam["type"] == "gauge":
                    gauges[key] = row["value"]
                else:
                    t, w = row["total"], row["window"]
                    hists[key] = {
                        "count": t["count"], "mean": t["mean"],
                        "p50": t["p50"], "p99": t["p99"],
                        "window_count": w["count"],
                        "window_p50": w["p50"], "window_p99": w["p99"]}
        with self._lock:
            slo_rows = list(self._last_slo)
            evaluations = self.evaluations
        return {"enabled": True, "host": self.host,
                "window_s": self.config.window_s,
                "windows": self.config.windows,
                "series": series_count(wire),
                "counters": counters, "gauges": gauges, "hists": hists,
                "slo": slo_rows,
                "watchdog": self.watchdog.summary()
                if self.watchdog is not None else None,
                "evaluations": evaluations,
                "events": self.events.summary()}

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


__all__ = ["TelemetryConfig", "Counter", "Gauge", "WindowedHistogram",
           "MetricsRegistry", "Telemetry", "merge_wire",
           "inject_labels", "series_count"]
