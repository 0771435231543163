"""Prometheus text exposition (format 0.0.4) for the metrics wire form
(the PyTorch package's copy of ``repro.obs.promexp``: the same text for
the same wire).

``render_wire`` turns a ``MetricsRegistry.collect()`` tree (or a
``merge_wire`` cluster view) into the plain-text format every
Prometheus-compatible scraper speaks: ``# HELP`` / ``# TYPE`` comment
lines followed by one sample line per series. Histograms render as the
classic cumulative triplet — ``_bucket{le="..."}`` lines with
monotonically non-decreasing counts, ``_sum``, ``_count``, and a final
``le="+Inf"`` bucket equal to ``_count``. Our log-bucketed histograms
map naturally: bucket ``i``'s upper bound is
``value_floor * 2**(i / buckets_per_doubling)`` and sparse empty runs
collapse into the next non-empty bucket's cumulative count.

``validate_exposition`` is the in-repo conformance check (tests and the
CI metrics smoke use it — no Prometheus binary in the container): it
parses the text back and returns a list of problems, empty when clean.

``MetricsHTTPServer`` is the tiny stdlib endpoint (`GET /metrics`)
GNNServer and the graph-host CLI mount; threaded, daemonized, port 0
picks an ephemeral port.
"""
from __future__ import annotations

import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _fmt_labels(labels: Dict[str, str],
                extra: Optional[Tuple[str, str]] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                          for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _bucket_bound(i: int, floor: float, per: int) -> float:
    """Upper bound of log bucket ``i`` (bucket 0 holds <= floor)."""
    return floor if i == 0 else floor * 2.0 ** (i / per)


def render_wire(wire: dict) -> str:
    """Render a metrics wire form to Prometheus text format 0.0.4."""
    out: List[str] = []
    for name, fam in wire.get("families", {}).items():
        mtype = fam["type"]
        help_ = fam.get("help") or name
        out.append(f"# HELP {name} "
                   + str(help_).replace("\\", r"\\").replace("\n", r"\n"))
        out.append(f"# TYPE {name} {mtype}")
        for row in fam.get("series", []):
            labels = row.get("labels", {})
            if mtype in ("counter", "gauge"):
                out.append(f"{name}{_fmt_labels(labels)} "
                           f"{_fmt_value(row.get('value', 0.0))}")
                continue
            # histogram: cumulative buckets from the lifetime total
            h = row.get("total") or {}
            counts = {int(k): int(v)
                      for k, v in (h.get("counts") or {}).items()}
            floor = h.get("value_floor", 1e-6)
            per = h.get("buckets_per_doubling", 16)
            cum = 0
            for i in sorted(counts):
                cum += counts[i]
                le = _fmt_value(_bucket_bound(i, floor, per))
                out.append(f"{name}_bucket"
                           f"{_fmt_labels(labels, ('le', le))} {cum}")
            total = int(h.get("count", 0))
            out.append(f"{name}_bucket"
                       f"{_fmt_labels(labels, ('le', '+Inf'))} {total}")
            s = float(h.get("mean", 0.0)) * total
            out.append(f"{name}_sum{_fmt_labels(labels)} "
                       f"{_fmt_value(s)}")
            out.append(f"{name}_count{_fmt_labels(labels)} {total}")
    return "\n".join(out) + "\n" if out else ""


# -- validator ----------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r" (?P<value>\S+)(?: (?P<ts>-?\d+))?$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_labels(raw: Optional[str]) -> Optional[Dict[str, str]]:
    if not raw:
        return {}
    body = raw[1:-1].rstrip(",")
    if not body:
        return {}
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(body):
        m = _LABEL_PAIR_RE.match(body, pos)
        if not m:
            return None
        labels[m.group(1)] = m.group(2)
        pos = m.end()
        if pos < len(body):
            if body[pos] != ",":
                return None
            pos += 1
    return labels


def validate_exposition(text: str) -> List[str]:
    """Parse Prometheus 0.0.4 text and return a list of problems
    (empty == conformant). Checks: name syntax, TYPE declared before
    samples and only known types, sample names matching their family
    (histogram suffixes allowed), label syntax, parseable values, no
    duplicate series, and histogram invariants — ``le`` monotonically
    increasing, cumulative bucket counts non-decreasing, the ``+Inf``
    bucket present and equal to ``_count``."""
    problems: List[str] = []
    types: Dict[str, str] = {}
    seen: set = set()
    # (family, labels-sans-le) -> [(le, cum_count)]
    hist_buckets: Dict[Tuple[str, tuple], List[Tuple[float, float]]] = {}
    hist_counts: Dict[Tuple[str, tuple], float] = {}

    def family_of(sample: str) -> Tuple[str, str]:
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample[:-len(suffix)] if sample.endswith(suffix) \
                else None
            if base and types.get(base) == "histogram":
                return base, suffix
        return sample, ""

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                if parts[1:2] and parts[1] in ("HELP", "TYPE"):
                    problems.append(f"line {ln}: malformed {parts[1]}")
                continue                       # plain comment is legal
            if parts[1] == "TYPE":
                name, mtype = parts[2], (parts[3] if len(parts) > 3
                                         else "")
                if not _NAME_RE.match(name):
                    problems.append(
                        f"line {ln}: bad metric name {name!r}")
                if mtype not in ("counter", "gauge", "histogram",
                                 "summary", "untyped"):
                    problems.append(
                        f"line {ln}: unknown type {mtype!r}")
                types[name] = mtype
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {ln}: unparseable sample {line!r}")
            continue
        sample = m.group("name")
        labels = _parse_labels(m.group("labels"))
        if labels is None:
            problems.append(f"line {ln}: bad label syntax in {line!r}")
            continue
        if not all(_LABEL_RE.match(k) for k in labels):
            problems.append(f"line {ln}: bad label name in {line!r}")
            continue
        raw_value = m.group("value")
        if raw_value in ("+Inf", "-Inf", "NaN"):
            value = {"+Inf": math.inf, "-Inf": -math.inf,
                     "NaN": math.nan}[raw_value]
        else:
            try:
                value = float(raw_value)
            except ValueError:
                problems.append(
                    f"line {ln}: bad value {raw_value!r}")
                continue
        family, suffix = family_of(sample)
        mtype = types.get(family)
        if mtype is None:
            problems.append(
                f"line {ln}: sample {sample!r} before its TYPE")
            types.setdefault(family, "untyped")
            mtype = "untyped"
        if mtype == "counter" and value < 0:
            problems.append(f"line {ln}: counter {sample!r} < 0")
        key = (sample, tuple(sorted(labels.items())))
        if key in seen:
            problems.append(f"line {ln}: duplicate series {key!r}")
        seen.add(key)
        if mtype == "histogram":
            base = {k: v for k, v in labels.items() if k != "le"}
            hkey = (family, tuple(sorted(base.items())))
            if suffix == "_bucket":
                if "le" not in labels:
                    problems.append(
                        f"line {ln}: histogram bucket without le")
                    continue
                le_raw = labels["le"]
                le = math.inf if le_raw == "+Inf" else None
                if le is None:
                    try:
                        le = float(le_raw)
                    except ValueError:
                        problems.append(
                            f"line {ln}: bad le {le_raw!r}")
                        continue
                hist_buckets.setdefault(hkey, []).append((le, value))
            elif suffix == "_count":
                hist_counts[hkey] = value
    for hkey, buckets in hist_buckets.items():
        les = [le for le, _ in buckets]
        cums = [c for _, c in buckets]
        if les != sorted(les):
            problems.append(f"{hkey[0]}: le buckets not increasing")
        if any(b < a for a, b in zip(cums, cums[1:])):
            problems.append(
                f"{hkey[0]}: cumulative bucket counts decrease")
        if not les or les[-1] != math.inf:
            problems.append(f"{hkey[0]}: missing +Inf bucket")
        elif hkey in hist_counts and cums[-1] != hist_counts[hkey]:
            problems.append(
                f"{hkey[0]}: +Inf bucket {cums[-1]} != _count "
                f"{hist_counts[hkey]}")
    return problems


# -- HTTP endpoint ------------------------------------------------------------

class MetricsHTTPServer:
    """Minimal threaded exposition endpoint.

    ``render_fn`` is called per scrape and must return the exposition
    text (so the server composes with any wire source: one registry, a
    lane merge, a cluster view). Routes: ``GET /metrics`` → text,
    ``GET /healthz`` → ``ok``; anything else is 404.
    """

    def __init__(self, render_fn: Callable[[], str],
                 host: str = "127.0.0.1", port: int = 0):
        self.render_fn = render_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] == "/metrics":
                    try:
                        body = outer.render_fn().encode()
                    except Exception as e:   # surface scrape bugs as 500s,
                        self.send_error(500, str(e))  # not dead sockets
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):        # keep scrapes off stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


__all__ = ["render_wire", "validate_exposition", "MetricsHTTPServer",
           "CONTENT_TYPE"]
