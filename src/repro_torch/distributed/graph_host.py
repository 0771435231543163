"""Graph host: the process that owns a graph partition and its caches.

The PyTorch package's copy of ``repro.distributed.graph_host``. A graph
host is a CPU process: it imports numpy and the host stages only, takes
no device argument and never touches a card.

The device host keeps the compiled ACK program and the feature store;
the graph host keeps the CSR graph, the neighborhood cache, and the
subgraph-row cache, and answers ``select_build`` calls by running the
SAME ``SelectStage``/``BuildStage`` objects the in-process pipeline uses
(core.batchplan) — so the remote path is the staged path by
construction, and bitwise-identical to it.

One service can answer for several registered models at once: stages are
cached per (receptive field, alpha, eps, e_pad) signature while the two
frontier caches are shared across them (entries key by that signature
already — ``nbr_key``).

Run standalone:

    python -m repro_torch.distributed.graph_host --dataset flickr \
        --scale 0.01 --seed 0 --port 0

prints ``GRAPH_HOST_LISTENING <host> <port>`` once ready (parents parse
this to discover an ephemeral port) and serves until a ``shutdown`` RPC
or SIGTERM.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.batchplan import BatchPlan, BuildStage, SelectStage
from repro_torch.distributed import wire
from repro_torch.obs.trace import SpanAllocator, now, span_dict
from repro_torch.store.nbr_cache import NeighborhoodCache, SubgraphRowCache


class _StagePair:
    """Select+Build stations for one model signature, duck-typing the
    slice of DecoupledEngine the stages read."""

    def __init__(self, service: "GraphHostService", n: int, alpha: float,
                 eps: float, e_pad: int):
        eng = SimpleNamespace(
            graph=service.graph,
            cfg=SimpleNamespace(receptive_field=n, ppr_alpha=alpha,
                                ppr_eps=eps),
            num_threads=service.num_threads,
            nbr_cache=service.nbr_cache,
            sg_cache=service.sg_cache,
            e_pad=e_pad,
            tracer=None)   # stages read eng.tracer; remote spans are
        #                    emitted by the service itself instead
        self.select = SelectStage(eng)
        self.build = BuildStage(eng)

    def close(self):
        self.select.close()


_INSTANCE_SEQ = itertools.count()


class GraphHostService:
    """RPC service owning one graph partition + its host-side caches.

    Methods (all reachable through ``handle``):
      select_build  targets -> node lists + SubgraphRows + cache counters
      invalidate    vertex ids -> dropped cache entries (both caches)
      report        cache stats + request counters
      metrics       this host's metrics registry in wire form (the
                    cluster-scrape building block: the device host
                    merges every host's wire losslessly)
      ping          liveness

    ``telemetry=TelemetryConfig(...)`` gives the host its own windowed
    metrics registry (select/build wall histograms + cache counters as
    collect-time callbacks); None (default) keeps the host metrics-free
    and the ``metrics`` method answers with an empty registry.
    """

    def __init__(self, graph, *, num_threads: int = 8,
                 nbr_cache_mode: str = "lru", nbr_capacity: int = 4096,
                 cache_rows: bool = True, row_capacity: int = 1024,
                 delay_s: float = 0.0, telemetry=None):
        self.graph = graph
        self.num_threads = num_threads
        # simulated one-way link latency (benchmarking only): lets a
        # single-machine run measure how much of a known RTT the device
        # host's pipelined remote stage hides
        self.delay_s = delay_s
        self.nbr_cache = (NeighborhoodCache(nbr_capacity)
                          if nbr_cache_mode != "none" else None)
        self.sg_cache = SubgraphRowCache(row_capacity) if cache_rows \
            else None
        self._pairs: Dict[Tuple, _StagePair] = {}
        self._lock = threading.Lock()
        self.requests = 0
        self.targets_served = 0
        # host-side observability (always on — two clock reads per call):
        # cumulative select/build wall split, so the device host's
        # store_report() can show WHERE remote prep time goes per host,
        # and span emission state for traced calls (payload["trace"])
        self.stage_times: Dict[str, float] = {"select": 0.0, "build": 0.0}
        self.spans_emitted = 0
        self._span_ids = SpanAllocator()
        # unique per process AND per in-process instance (an inproc
        # cluster scrape must keep same-pid hosts distinguishable)
        seq = next(_INSTANCE_SEQ)
        self._span_host = f"graph-host:{os.getpid()}" + \
            (f".{seq}" if seq else "")
        # per-host telemetry registry (opt-in; the hot path pays one
        # ``is None`` test plus two histogram records per select_build)
        if telemetry is not None:
            from repro_torch.obs.metrics import MetricsRegistry
            reg = MetricsRegistry(self._span_host,
                                  window_s=telemetry.window_s,
                                  windows=telemetry.windows)
            self._h_select = reg.whist(
                "repro_host_select_seconds",
                help="graph-host Select stage wall time")
            self._h_build = reg.whist(
                "repro_host_build_seconds",
                help="graph-host Build stage wall time")
            reg.counter_fn("repro_host_requests_total",
                           lambda: self.requests,
                           help="select_build calls answered")
            reg.counter_fn("repro_host_targets_total",
                           lambda: self.targets_served,
                           help="targets served")
            if self.nbr_cache is not None:
                nc = self.nbr_cache
                reg.counter_fn("repro_nbr_cache_hits_total",
                               lambda: nc.hits,
                               help="neighborhood cache hits")
                reg.counter_fn("repro_nbr_cache_misses_total",
                               lambda: nc.misses,
                               help="neighborhood cache misses")
                reg.counter_fn("repro_nbr_cache_evictions_total",
                               lambda: nc.evictions,
                               help="neighborhood cache evictions")
            if self.sg_cache is not None:
                rc = self.sg_cache
                reg.counter_fn("repro_row_cache_hits_total",
                               lambda: rc.hits,
                               help="subgraph-row cache hits")
                reg.counter_fn("repro_row_cache_misses_total",
                               lambda: rc.misses,
                               help="subgraph-row cache misses")
            self.registry = reg
        else:
            self.registry = None
            self._h_select = None
            self._h_build = None

    def _pair(self, n: int, alpha: float, eps: float,
              e_pad: int) -> _StagePair:
        key = (int(n), float(alpha), float(eps), int(e_pad))
        with self._lock:
            pair = self._pairs.get(key)
            if pair is None:
                pair = _StagePair(self, *key)
                self._pairs[key] = pair
        return pair

    # -- RPC methods ---------------------------------------------------------
    def select_build(self, payload: dict) -> dict:
        pair = self._pair(payload["n"], payload["alpha"], payload["eps"],
                          payload["e_pad"])
        plan = BatchPlan(targets=np.asarray(payload["targets"],
                                            dtype=np.int64))
        t0 = now()
        plan = pair.select.run(plan)
        t1 = now()
        plan = pair.build.run(plan)
        t2 = now()
        with self._lock:
            self.requests += 1
            self.targets_served += len(plan.targets)
            self.stage_times["select"] += t1 - t0
            self.stage_times["build"] += t2 - t1
        if self._h_select is not None:
            self._h_select.record(t1 - t0)
            self._h_build.record(t2 - t1)
        result = {"node_lists": wire.node_lists_to_wire(plan.node_lists),
                  "rows": wire.rows_to_wire(plan.rows, plan.e_pad),
                  "nbr_hits": plan.nbr_hits,
                  "nbr_misses": plan.nbr_misses,
                  "build_hits": plan.build_hits,
                  "build_misses": plan.build_misses}
        trace = payload.get("trace")
        if trace is not None:
            # traced call: emit this host's select/build spans, children
            # of the CLIENT's rpc-stage span. Timestamps are THIS
            # process's clock — the client shifts them by its ping-based
            # offset estimate when stitching (tracer.ingest_remote).
            # Span ids come from this process's allocator (pid-prefixed,
            # so they can never collide with the client's ids).
            tid = threading.get_ident() & 0xFFFFFF
            common = dict(trace_id=int(trace["trace_id"]),
                          parent_id=int(trace["parent"]),
                          host=self._span_host, cat="remote")
            result["spans"] = [
                span_dict(name="remote.select",
                          span_id=self._span_ids.next_id(),
                          t0=t0, dur=t1 - t0, track="remote.select",
                          args={"tid": tid, "nbr_hits": plan.nbr_hits,
                                "nbr_misses": plan.nbr_misses},
                          **common),
                span_dict(name="remote.build",
                          span_id=self._span_ids.next_id(),
                          t0=t1, dur=t2 - t1, track="remote.build",
                          args={"tid": tid, "build_hits": plan.build_hits,
                                "build_misses": plan.build_misses},
                          **common)]
            with self._lock:
                self.spans_emitted += 2
        return result

    def invalidate(self, payload: dict) -> dict:
        vs = np.asarray(payload["vertices"], dtype=np.int64)
        dropped = 0
        if self.sg_cache is not None:
            dropped += self.sg_cache.invalidate(vs)
        if self.nbr_cache is not None:
            dropped += self.nbr_cache.invalidate(vs)
        return {"dropped": dropped}

    def report(self, payload: Optional[dict] = None) -> dict:
        with self._lock:
            stage_times = {k: round(v, 6)
                           for k, v in self.stage_times.items()}
        r = {"requests": self.requests,
             "targets_served": self.targets_served,
             # host-side Select/Build wall split + span counters, so the
             # device host's store_report() shows WHERE remote prep time
             # goes per host, not just call totals
             "stage_times": stage_times,
             "spans_emitted": self.spans_emitted,
             "models": [list(k) for k in self._pairs]}
        if self.nbr_cache is not None:
            r["nbr_cache"] = self.nbr_cache.stats()
        if self.sg_cache is not None:
            r["subgraph_cache"] = self.sg_cache.stats()
        return r

    def metrics(self, payload: Optional[dict] = None) -> dict:
        """This host's metrics registry in wire form (JSON scalars only,
        so it crosses the wire codec unchanged). Telemetry-free hosts
        answer with an empty registry rather than erroring — a mixed
        deployment's cluster scrape just sees fewer series."""
        if self.registry is None:
            return {"host": self._span_host, "families": {}}
        return self.registry.collect()

    def ping(self, payload: Optional[dict] = None) -> dict:
        # "clock" is this process's monotonic wall clock (obs.trace.now):
        # the client's ping loop turns (send time, rtt, clock) into a
        # per-endpoint offset estimate for stitching remote spans
        return {"pong": True, "num_vertices": self.graph.num_vertices,
                "clock": now()}

    # -- dispatch ------------------------------------------------------------
    _METHODS = ("select_build", "invalidate", "report", "metrics",
                "ping")

    def handle(self, request: dict) -> dict:
        method = request.get("method")
        if self.delay_s:
            time.sleep(self.delay_s)
        t0 = time.perf_counter()
        if method not in self._METHODS:
            return {"ok": False, "method": method,
                    "error": f"unknown method {method!r}; "
                             f"available: {list(self._METHODS)}",
                    "error_type": "LookupError"}
        try:
            result = getattr(self, method)(request.get("payload"))
        except Exception as e:                     # noqa: BLE001
            return {"ok": False, "method": method, "error": str(e),
                    "error_type": type(e).__name__}
        return {"ok": True, "result": result,
                "remote_s": time.perf_counter() - t0}

    def close(self):
        with self._lock:
            pairs, self._pairs = list(self._pairs.values()), {}
        for p in pairs:
            p.close()


def main(argv=None) -> int:
    import argparse

    from repro_torch.distributed.rpc import GraphHostServer
    from repro_torch.graphs.synthetic import get_graph

    ap = argparse.ArgumentParser(
        description="Serve one graph partition's Select/Build stages "
                    "over a SocketTransport endpoint.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral; the chosen port is printed")
    ap.add_argument("--dataset", default="flickr")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0,
                    help="must match the device host so both processes "
                         "materialize the identical synthetic graph")
    ap.add_argument("--num-threads", type=int, default=4)
    ap.add_argument("--nbr-cache", default="lru",
                    choices=("lru", "none"))
    ap.add_argument("--nbr-capacity", type=int, default=4096)
    ap.add_argument("--no-row-cache", action="store_true")
    ap.add_argument("--row-capacity", type=int, default=1024)
    ap.add_argument("--delay-ms", type=float, default=0.0,
                    help="simulated link latency per call (benchmarks)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus exposition on this port "
                         "(0 = ephemeral, printed; default = off); "
                         "also enables the host's telemetry registry")
    ap.add_argument("--metrics-window-s", type=float, default=60.0,
                    help="telemetry sliding-window length")
    args = ap.parse_args(argv)

    telemetry = None
    if args.metrics_port is not None:
        from repro_torch.obs.metrics import TelemetryConfig
        telemetry = TelemetryConfig(port=args.metrics_port,
                                    window_s=args.metrics_window_s)
    graph = get_graph(args.dataset, scale=args.scale, seed=args.seed)
    service = GraphHostService(
        graph, num_threads=args.num_threads,
        nbr_cache_mode=args.nbr_cache, nbr_capacity=args.nbr_capacity,
        cache_rows=not args.no_row_cache, row_capacity=args.row_capacity,
        delay_s=args.delay_ms / 1e3, telemetry=telemetry)
    metrics_server = None
    if telemetry is not None:
        from repro_torch.obs.promexp import MetricsHTTPServer, render_wire
        metrics_server = MetricsHTTPServer(
            lambda: render_wire(service.metrics()),
            host=args.host, port=telemetry.port)
        print(f"GRAPH_HOST_METRICS {metrics_server.host} "
              f"{metrics_server.port}", flush=True)
    server = GraphHostServer(service, host=args.host, port=args.port)
    print(f"GRAPH_HOST_LISTENING {server.host} {server.port}",
          flush=True)
    try:
        server.wait()
    except KeyboardInterrupt:
        server.close()
    finally:
        if metrics_server is not None:
            metrics_server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
