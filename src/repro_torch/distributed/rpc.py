"""RPC transport for multi-host graph serving (paper §4.4 at host scale).

The PyTorch package's copy of ``repro.distributed.rpc`` (numpy only). A
failed call raises ``TransportError``; nothing falls back to running
Select/Build in-process.

The paper hides the CPU->FPGA hop with task scheduling; the same move
works across HOSTS: graph-owning processes run the irregular Select/Build
stages next to their partition's caches, the device host runs Pack +
device execution, and the scheduler's stage stations hide the hop under
neighboring batches (DGL's distributed RPC layer is the exemplar shape).

Three layers, smallest first:

* ``Transport`` — one request/response channel speaking wire.py frames.
  ``InProcTransport`` is the hermetic loopback: it encodes AND decodes
  both legs, so every tier-1 byte crosses the real codec while results
  stay bitwise-checkable in one process. ``SocketTransport`` is TCP with
  u-length framing via the wire header, a small connection pool (so a
  multi-worker remote stage keeps several requests in flight), and
  typed timeout/failure errors.
* ``HostPool`` — routes calls across a pool of graph hosts (round-robin
  or partition-affine), enforces the per-call timeout, retries failures
  on the next host up to ``retries`` times, and quarantines dead hosts
  for ``cooldown_s`` so one crash degrades capacity instead of wedging
  the pipeline.
* ``RemoteSelectBuildStage`` — the scheduler-facing spelling: one
  ``PlanStage`` that ships a batch's targets to a graph host and grafts
  the returned node lists / SubgraphRows / cache counters back onto the
  BatchPlan. A transport failure raises out of the stage, which the
  scheduler already isolates to THAT ticket (failure -> ticket error,
  pipeline keeps flowing).
"""
from __future__ import annotations

import itertools
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batchplan import BatchPlan, PlanStage
from repro_torch.distributed import wire


class TransportError(ConnectionError):
    """The transport failed to deliver the call (dead peer, broken
    connection, unreachable endpoint). Retryable on another host."""


class RPCTimeout(TransportError):
    """The peer did not answer within the per-call timeout."""


class RemoteCallError(RuntimeError):
    """The peer received the call and raised while executing it. NOT
    retried: the failure is deterministic application state, not the
    link."""


@dataclass
class CallMeta:
    """Per-call accounting a transport hands back with the result."""
    bytes_out: int = 0
    bytes_in: int = 0
    remote_s: float = 0.0     # peer-reported handler wall time
    wire_s: float = 0.0       # encode+decode time on THIS side
    retries: int = 0          # filled by HostPool
    timeouts: int = 0
    endpoint: str = ""


class Transport:
    """One request/response channel. ``call`` returns (result, CallMeta)
    or raises TransportError / RPCTimeout / RemoteCallError."""

    endpoint = "?"

    def call(self, method: str, payload: Any,
             timeout: Optional[float] = None
             ) -> Tuple[Any, CallMeta]:
        raise NotImplementedError

    def close(self):
        pass


def _raise_remote(resp: dict, endpoint: str):
    if not resp.get("ok"):
        raise RemoteCallError(
            f"graph host {endpoint} failed "
            f"{resp.get('method', '?')!r}: "
            f"[{resp.get('error_type', 'Error')}] "
            f"{resp.get('error', 'unknown error')}")


class InProcTransport(Transport):
    """Loopback transport: dispatches to a service object in-process but
    runs the FULL wire codec on both legs of both directions — request
    encode->decode before the handler, response encode->decode after —
    so tier-1 stays hermetic while every payload byte is proven to
    survive the wire bitwise."""

    endpoint = "inproc"

    def __init__(self, service, owns_service: bool = False):
        self.service = service
        self._owns = owns_service

    def call(self, method, payload, timeout=None):
        t0 = time.perf_counter()
        req = wire.encode({"method": method, "payload": payload})
        request = wire.decode(req)
        t_wire = time.perf_counter() - t0
        resp_obj = self.service.handle(request)
        t1 = time.perf_counter()
        resp_frame = wire.encode(resp_obj)
        resp = wire.decode(resp_frame)
        t_wire += time.perf_counter() - t1
        _raise_remote(resp, self.endpoint)
        return resp["result"], CallMeta(
            bytes_out=len(req), bytes_in=len(resp_frame),
            remote_s=float(resp.get("remote_s", 0.0)), wire_s=t_wire,
            endpoint=self.endpoint)

    def close(self):
        if self._owns and hasattr(self.service, "close"):
            self.service.close()


def _recv_frame(sock: socket.socket) -> bytes:
    """Read exactly one wire frame: 14-byte header, then the declared
    remainder."""
    header = _recv_exact(sock, 14)
    total = wire.frame_length(header)
    return header + _recv_exact(sock, total - len(header))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


class SocketTransport(Transport):
    """TCP transport to one graph host ("host:port"). Keeps a small pool
    of idle connections so several stage workers can have calls in
    flight concurrently (that concurrency is what hides the hop under
    pipelined traffic); dials lazily and drops a connection on any
    failure rather than reusing a possibly-desynced stream."""

    def __init__(self, endpoint: str, *, connect_timeout: float = 5.0,
                 max_idle_conns: int = 8):
        host, _, port = endpoint.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"endpoint {endpoint!r} is not 'host:port'")
        self.endpoint = endpoint
        self._addr = (host, int(port))
        self._connect_timeout = connect_timeout
        self._max_idle = max_idle_conns
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise TransportError(
                    f"transport to {self.endpoint} is closed")
            if self._idle:
                return self._idle.pop()
        try:
            s = socket.create_connection(
                self._addr, timeout=self._connect_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s
        except OSError as e:
            raise TransportError(
                f"cannot connect to graph host {self.endpoint}: {e}"
            ) from e

    def _checkin(self, s: socket.socket):
        with self._lock:
            if not self._closed and len(self._idle) < self._max_idle:
                self._idle.append(s)
                return
        s.close()

    def call(self, method, payload, timeout=None):
        t0 = time.perf_counter()
        req = wire.encode({"method": method, "payload": payload})
        t_wire = time.perf_counter() - t0
        s = self._checkout()
        try:
            s.settimeout(timeout)
            s.sendall(req)
            resp_frame = _recv_frame(s)
        except socket.timeout as e:
            s.close()
            raise RPCTimeout(
                f"graph host {self.endpoint} did not answer "
                f"{method!r} within {timeout}s") from e
        except (OSError, ConnectionError, wire.WireFormatError) as e:
            s.close()
            raise TransportError(
                f"call {method!r} to graph host {self.endpoint} "
                f"failed: {e}") from e
        self._checkin(s)
        t1 = time.perf_counter()
        resp = wire.decode(resp_frame)
        t_wire += time.perf_counter() - t1
        _raise_remote(resp, self.endpoint)
        return resp["result"], CallMeta(
            bytes_out=len(req), bytes_in=len(resp_frame),
            remote_s=float(resp.get("remote_s", 0.0)), wire_s=t_wire,
            endpoint=self.endpoint)

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for s in idle:
            s.close()


class GraphHostServer:
    """Threaded frame server around a service object: one accept loop,
    one thread per connection, each request dispatched to
    ``service.handle(request) -> response``. ``"shutdown"`` is handled
    by the server itself (acknowledge, then stop accepting)."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.host, self.port = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="graph-host-accept", daemon=True)
        self._accept_thread.start()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                try:
                    frame = _recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                try:
                    request = wire.decode(frame)
                except wire.WireError as e:
                    conn.sendall(wire.encode(
                        {"ok": False, "error": str(e),
                         "error_type": type(e).__name__}))
                    continue
                if request.get("method") == "shutdown":
                    conn.sendall(wire.encode({"ok": True, "result": None,
                                              "remote_s": 0.0}))
                    threading.Thread(target=self.close,
                                     daemon=True).start()
                    return
                conn.sendall(wire.encode(self.service.handle(request)))
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        if hasattr(self.service, "close"):
            self.service.close()

    def wait(self):
        """Block until the server is shut down (CLI main loop)."""
        while not self._stop.wait(0.2):
            pass


@dataclass
class PoolCallMeta(CallMeta):
    """CallMeta plus the routing outcome across the pool."""
    wall_s: float = 0.0


class HostPool:
    """Route calls across a pool of graph hosts with timeout, bounded
    retry, and dead-host quarantine.

    routing="round_robin" spreads batches evenly; "affine" pins a call's
    ``affinity`` key (e.g. the batch's first target id) to a fixed host,
    so a partition-affine deployment keeps each host's caches hot for
    its own vertex range. A host that times out or drops the connection
    is marked down for ``cooldown_s`` and skipped while alternatives are
    healthy; the call retries on the next host up to ``retries`` times
    before the error reaches the ticket."""

    def __init__(self, transports: Sequence[Transport], *,
                 timeout: Optional[float] = 30.0, retries: int = 2,
                 routing: str = "round_robin", cooldown_s: float = 5.0,
                 on_quarantine=None):
        if not transports:
            raise ValueError("HostPool needs at least one transport")
        if routing not in ("round_robin", "affine"):
            raise ValueError(f"routing={routing!r}, expected "
                             "'round_robin' or 'affine'")
        self.transports = list(transports)
        self.timeout = timeout
        self.retries = int(retries)
        self.routing = routing
        self.cooldown_s = cooldown_s
        # fired once per quarantine EPISODE with the endpoint string
        # (telemetry hook: the engine routes it into the event ring);
        # re-marks while already down stay silent
        self.on_quarantine = on_quarantine
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._down_until = [0.0] * len(self.transports)

    def __len__(self) -> int:
        return len(self.transports)

    @property
    def endpoints(self) -> List[str]:
        return [t.endpoint for t in self.transports]

    def _mark_down(self, i: int):
        now = time.monotonic()
        with self._lock:
            fresh = self._down_until[i] <= now
            self._down_until[i] = now + self.cooldown_s
        if fresh and self.on_quarantine is not None:
            try:
                self.on_quarantine(self.transports[i].endpoint)
            except Exception:    # a telemetry hook must never break
                pass             # routing

    def _mark_up(self, i: int):
        with self._lock:
            self._down_until[i] = 0.0

    def _candidates(self, affinity: Optional[int]) -> List[int]:
        n = len(self.transports)
        if self.routing == "affine" and affinity is not None:
            start = int(affinity) % n
        else:
            start = next(self._rr) % n
        order = [(start + k) % n for k in range(n)]
        now = time.monotonic()
        with self._lock:
            healthy = [i for i in order if self._down_until[i] <= now]
        return healthy or order      # all down: try anyway

    def call(self, method: str, payload: Any,
             affinity: Optional[int] = None) -> Tuple[Any, PoolCallMeta]:
        t_start = time.perf_counter()
        attempts = self.retries + 1
        candidates = self._candidates(affinity)
        errors: List[str] = []
        timeouts = 0
        for attempt in range(attempts):
            i = candidates[attempt % len(candidates)]
            tr = self.transports[i]
            try:
                result, meta = tr.call(method, payload,
                                       timeout=self.timeout)
            except RPCTimeout as e:
                timeouts += 1
                errors.append(str(e))
                self._mark_down(i)
                last: TransportError = e
            except TransportError as e:
                errors.append(str(e))
                self._mark_down(i)
                last = e
            else:
                self._mark_up(i)
                return result, PoolCallMeta(
                    bytes_out=meta.bytes_out, bytes_in=meta.bytes_in,
                    remote_s=meta.remote_s, wire_s=meta.wire_s,
                    retries=attempt, timeouts=timeouts,
                    endpoint=meta.endpoint,
                    wall_s=time.perf_counter() - t_start)
        raise type(last)(
            f"{method!r} failed after {attempts} attempt(s) across "
            f"{min(attempts, len(candidates))} host(s): "
            + " | ".join(errors))

    def broadcast(self, method: str, payload: Any) -> List[Any]:
        """Best-effort call on EVERY host (cache invalidation, report):
        per-host failures are returned as None, never raised — a dead
        host cannot hold stale state anyway."""
        out = []
        for i, tr in enumerate(self.transports):
            try:
                result, _ = tr.call(method, payload, timeout=self.timeout)
                self._mark_up(i)
                out.append(result)
            except (TransportError, RemoteCallError):
                self._mark_down(i)
                out.append(None)
        return out

    def report(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            down = [u > now for u in self._down_until]
        return [{"endpoint": t.endpoint, "healthy": not d}
                for t, d in zip(self.transports, down)]

    def close(self):
        for t in self.transports:
            t.close()


class RemoteSelectBuildStage(PlanStage):
    """Select+Build as ONE remote station: ship the batch's targets to a
    graph host, graft the returned node lists / SubgraphRows / counters
    back onto the BatchPlan, and hand it to the local Pack stage. The
    station runs ``workers`` concurrent calls so the hop overlaps with
    itself under pipelined traffic (triple buffering across the wire).

    Failures raise out of ``run``; the scheduler's stage-step already
    converts that into a per-ticket error, so a dead graph host fails
    the in-flight tickets and the pool's quarantine reroutes the rest —
    degrade, not wedge."""

    name = "select_build"

    def __init__(self, engine, pool: HostPool, workers: int = 4):
        self.engine = engine
        self.pool = pool
        self.workers = max(1, int(workers))

    def run(self, plan) -> BatchPlan:
        if not isinstance(plan, BatchPlan):
            plan = BatchPlan(targets=np.asarray(plan))
        if plan.tier_done:       # all targets served from the embedding
            return plan          # tier — skip the remote hop entirely
        eng = self.engine
        cfg = eng.cfg
        payload = {
            "targets": np.asarray(plan.targets, dtype=np.int64),
            "n": int(cfg.receptive_field),
            "alpha": float(cfg.ppr_alpha),
            "eps": float(cfg.ppr_eps),
            "e_pad": int(eng.e_pad),
        }
        tracer = getattr(eng, "tracer", None)
        if tracer is not None:
            # the scheduler opened this ticket's stage span on THIS
            # thread; its ids ride the wire meta so the graph host's
            # spans come back parented under it (cross-host stitching)
            ids = tracer.current_ids()
            if ids is not None:
                payload["trace"] = {"trace_id": ids[0], "parent": ids[1]}
        affinity = int(plan.targets[0]) if len(plan.targets) else 0
        t0 = time.perf_counter()
        try:
            result, meta = self.pool.call("select_build", payload,
                                          affinity=affinity)
        except TransportError as e:
            eng.scheduler.note_rpc_metrics(
                calls=1, errors=1, retries=self.pool.retries,
                timeouts=1 if isinstance(e, RPCTimeout) else 0,
                wall=time.perf_counter() - t0)
            raise
        plan.node_lists = wire.node_lists_from_wire(result["node_lists"])
        plan.rows = wire.rows_from_wire(result["rows"])
        plan.nbr_hits = int(result["nbr_hits"])
        plan.nbr_misses = int(result["nbr_misses"])
        plan.build_hits = int(result["build_hits"])
        plan.build_misses = int(result["build_misses"])
        eng.scheduler.note_rpc_metrics(
            calls=1, bytes_out=meta.bytes_out, bytes_in=meta.bytes_in,
            retries=meta.retries, timeouts=meta.timeouts,
            wall=time.perf_counter() - t0, remote=meta.remote_s,
            wire=meta.wire_s)
        if tracer is not None and "trace" in payload:
            tracer.annotate(endpoint=meta.endpoint,
                            bytes_out=meta.bytes_out,
                            bytes_in=meta.bytes_in,
                            retries=meta.retries,
                            remote_s=round(meta.remote_s, 6))
            spans = result.get("spans")
            if spans:
                tracer.ingest_remote(spans, meta.endpoint)
        return plan


def estimate_clock_offsets(pool: HostPool, pings: int = 5) -> dict:
    """Ping-based clock sync per graph host: for each transport, send
    ``pings`` pings, and from the round trip with the SMALLEST rtt (the
    one least contaminated by queueing) estimate

        offset = remote_clock - (t_send + rtt / 2)

    i.e. the remote wall clock minus the local one under the symmetric-
    link assumption. ``tracer.ingest_remote`` subtracts the offset from
    remote span timestamps to map them onto the client timeline; the
    residual error is bounded by the link's asymmetry (at most rtt/2).
    Hosts that fail to answer or predate the ``clock`` ping field are
    skipped — their spans stitch unshifted."""
    from repro_torch.obs.trace import now
    out = {}
    for tr in pool.transports:
        best = None
        for _ in range(max(1, pings)):
            t_send = now()
            try:
                result, _ = tr.call("ping", None, timeout=pool.timeout)
            except (TransportError, RemoteCallError):
                break
            rtt = now() - t_send
            clock = result.get("clock") if isinstance(result, dict) \
                else None
            if clock is None:        # pre-observability peer
                break
            if best is None or rtt < best[0]:
                best = (rtt, float(clock) - (t_send + rtt / 2.0))
        if best is not None:
            out[tr.endpoint] = {"offset_s": best[1], "rtt_s": best[0]}
    return out


def build_host_pool(config, graph=None) -> HostPool:
    """Resolve a ServingConfig's transport section into a HostPool.

    transport="inproc" spins up a private GraphHostService over the
    loopback transport (hermetic: full codec, one process);
    transport="socket" dials ``config.endpoints``."""
    if config.transport == "inproc":
        if graph is None:
            raise ValueError("transport='inproc' needs the graph")
        from repro_torch.distributed.graph_host import GraphHostService
        pol = config.store
        svc = GraphHostService(
            graph, num_threads=config.num_threads,
            nbr_cache_mode=pol.nbr_cache if pol.nbr_cache != "none"
            else "lru",
            nbr_capacity=pol.nbr_capacity,
            cache_rows=True,
            telemetry=getattr(config, "telemetry", None))
        transports: List[Transport] = [
            InProcTransport(svc, owns_service=True)]
    elif config.transport == "socket":
        transports = [SocketTransport(ep) for ep in config.endpoints]
    else:
        raise ValueError(
            f"transport={config.transport!r} has no host pool "
            "(transport='local' runs Select/Build in-process)")
    return HostPool(transports, timeout=config.rpc_timeout_s,
                    retries=config.rpc_retries, routing=config.routing)


__all__ = ["Transport", "InProcTransport", "SocketTransport",
           "GraphHostServer", "HostPool", "RemoteSelectBuildStage",
           "TransportError", "RPCTimeout", "RemoteCallError",
           "CallMeta", "PoolCallMeta", "build_host_pool",
           "estimate_clock_offsets"]
