"""Multi-host graph serving in the PyTorch package, on the CPU.

Mirrors tests/test_rpc.py within the port: the wire codec's exactness
(round trips, corrupt / truncated / cross-version frames), remote
Select/Build bitwise equal to the in-process pipeline over the loopback
transport, a real TCP socket and a graph host in another process
(``python -m repro_torch.distributed.graph_host``), per-call timeouts,
bounded retry, application errors not retried, affine routing and the
kill-a-graph-host degradation path. Then across the two packages: the
same plan encodes to the same bytes, a port engine is served by a
reference graph host and a reference engine by a port graph host (each
bitwise equal to its own local engine), and the port's remote engine
agrees with the reference's at tests/test_torch_engine.py's tolerance.
Last, the two repairs the transport depends on: Pack recomputes the batch
density of a plan decoded from the wire, so an adaptive engine behind the
transport takes the local engine's decisions; and a traced remote engine
stitches the graph hosts' spans into a valid export."""
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

import repro_torch  # noqa: E402
from repro.core.config import ServingConfig as JConfig  # noqa: E402
from repro.core.engine import DecoupledEngine as JEngine  # noqa: E402
from repro.distributed import wire as j_wire  # noqa: E402
from repro.distributed.graph_host import \
    GraphHostService as JGraphHostService  # noqa: E402
from repro.distributed.rpc import GraphHostServer as JServer  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN, init_gnn as j_init  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro.store import StorePolicy as JPolicy  # noqa: E402
from repro_torch.core.batchplan import BatchPlan, PackStage  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.dispatch import DispatchConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.program import (compile_steps, mux_sites,  # noqa: E402
                                      respecialize)
from repro_torch.distributed import wire  # noqa: E402
from repro_torch.distributed.graph_host import GraphHostService  # noqa: E402
from repro_torch.distributed.rpc import (GraphHostServer,  # noqa: E402
                                         HostPool, InProcTransport,
                                         RemoteCallError, RPCTimeout,
                                         SocketTransport, TransportError)
from repro_torch.gnn.model import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.obs import TraceConfig, validate_chrome_trace  # noqa: E402
from repro_torch.obs.calib import size_bucket  # noqa: E402
from repro_torch.store import StorePolicy  # noqa: E402

N = 16
C = 4
SCALE = 0.004            # ~357 vertices
SEED = 1
TARGETS = np.arange(12)
# tests/test_torch_engine.py's tolerance between the two packages
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=SCALE, seed=SEED)


@pytest.fixture(scope="module")
def jgraph():
    return j_get_graph("flickr", scale=SCALE, seed=SEED)


def _cfg(kind, graph):
    return GNNConfig(kind=kind, n_layers=2, receptive_field=N,
                     f_in=graph.feature_dim)


def _jcfg(kind, graph):
    return JGNN(kind=kind, n_layers=2, receptive_field=N,
                f_in=graph.feature_dim)


def _sc(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("impl", "torch")
    kw.setdefault("batch_size", C)
    kw.setdefault("num_threads", 2)
    return ServingConfig(**kw)


def _subproc_env():
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _spawn_graph_host(extra_args=()):
    """Launch a port graph host subprocess serving the SAME synthetic
    graph (dataset+scale+seed pin it bitwise) and return (proc,
    endpoint)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.distributed.graph_host",
         "--dataset", "flickr", "--scale", str(SCALE),
         "--seed", str(SEED), "--port", "0", "--num-threads", "2",
         *extra_args],
        env=_subproc_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t0 = time.time()
    while True:
        line = proc.stdout.readline()
        if line.startswith("GRAPH_HOST_LISTENING"):
            _, host, port = line.split()
            return proc, f"{host}:{port}"
        if proc.poll() is not None or time.time() - t0 > 60:
            proc.kill()
            raise RuntimeError(f"graph host failed to start: {line!r}")


def _stop(*procs):
    for p in procs:
        p.kill()
        p.wait(timeout=10)


class TestWireCodec:
    def test_roundtrip_every_dtype_and_shape(self):
        rng = np.random.default_rng(0)
        arrays = [
            np.asarray(7, np.int32),                       # 0-d scalar
            np.empty((0, 3), np.float32),                  # empty
            rng.integers(-9, 9, (5,), endpoint=True).astype(np.int8),
            rng.integers(0, 2**31, (3, 4)).astype(np.int64),
            rng.standard_normal((2, 3, 4)).astype(np.float32),
            rng.standard_normal((8,)).astype(np.float64),
            np.array([True, False, True]),
        ]
        tree = {"arrays": arrays, "s": "x", "i": 3, "f": 0.5,
                "none": None, "flag": True, "nested": {"a": arrays[4]},
                "blob": b"\x00\xffraw"}
        out = wire.decode(wire.encode(tree))
        for a, b in zip(arrays, out["arrays"]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert out["s"] == "x" and out["i"] == 3 and out["f"] == 0.5
        assert out["none"] is None and out["flag"] is True
        assert out["blob"] == b"\x00\xffraw"
        np.testing.assert_array_equal(out["nested"]["a"], arrays[4])
        # one format: both packages encode a tree to the same bytes
        assert wire.encode(tree) == j_wire.encode(tree)

    def test_batchplan_roundtrip_exact(self, graph):
        """Full BatchPlan — node lists, frontiers, rows, device payload
        with the store's generation pin — survives the wire bitwise."""
        cfg = _cfg("gcn", graph)
        with DecoupledEngine(graph, cfg, config=_sc(
                store=StorePolicy(features="resident",
                                  nbr_cache="lru"))) as eng:
            plan = eng.plan(TARGETS[:C])
            out = wire.plan_from_wire(
                wire.decode(wire.encode(wire.plan_to_wire(plan))))
            assert isinstance(out, BatchPlan)
            np.testing.assert_array_equal(out.targets, plan.targets)
            assert len(out.node_lists) == len(plan.node_lists)
            for a, b in zip(plan.node_lists, out.node_lists):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            for t, fr in plan.frontiers.items():
                np.testing.assert_array_equal(out.frontiers[t], fr)
            for a, b in zip(plan.rows, out.rows):
                for f in ("adj", "adj_mean", "mask", "edge_src",
                          "edge_dst", "edge_w", "self_w", "edge_w_mean"):
                    ax, bx = getattr(a, f), getattr(b, f)
                    assert ax.dtype == bx.dtype
                    np.testing.assert_array_equal(ax, bx)
            assert set(out.device) == set(plan.device)
            for k in plan.device:
                a, b = np.asarray(plan.device[k]), out.device[k]
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            # generation pin survives the hop (resident store)
            assert int(out.device["store_gen"]) \
                == int(plan.device["store_gen"])
            eng.run_device(plan)     # consume the pinned generation

    def test_sharded_payload_roundtrip_exact(self, graph):
        cfg = _cfg("gcn", graph)
        with DecoupledEngine(graph, cfg, config=_sc(
                store=StorePolicy(features="sharded",
                                  num_shards=2))) as eng:
            plan = eng.plan(TARGETS[:C])
            out = wire.decode(wire.encode(
                {k: np.asarray(v) for k, v in plan.device.items()}))
            for k, v in plan.device.items():
                a = np.asarray(v)
                assert a.dtype == out[k].dtype and a.shape == out[k].shape
                np.testing.assert_array_equal(a, out[k])
            assert int(out["shard_gen"]) == int(plan.device["shard_gen"])
            eng.run_device(plan)

    def test_truncated_frame_rejected(self):
        frame = wire.encode({"a": np.arange(100)})
        with pytest.raises(wire.WireFormatError, match="truncated"):
            wire.decode(frame[:-10])
        with pytest.raises(wire.WireFormatError, match="header"):
            wire.decode(frame[:6])

    def test_corrupt_magic_rejected(self):
        frame = bytearray(wire.encode({"a": 1}))
        frame[:4] = b"EVIL"
        with pytest.raises(wire.WireFormatError, match="magic"):
            wire.decode(bytes(frame))

    def test_version_mismatch_actionable(self):
        assert (wire.MAGIC, wire.WIRE_VERSION) \
            == (j_wire.MAGIC, j_wire.WIRE_VERSION)
        frame = bytearray(wire.encode({"a": 1}))
        frame[4:6] = (99).to_bytes(2, "big")
        with pytest.raises(wire.WireVersionError,
                           match="v99.*v1|upgrade"):
            wire.decode(bytes(frame))

    def test_unencodable_value_rejected(self):
        with pytest.raises(wire.WireFormatError, match="cannot encode"):
            wire.encode({"bad": object()})


class TestRemoteBitwise:
    @pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
    def test_inproc_loopback_matches_local(self, graph, kind):
        """Remote Select/Build over the loopback transport (full codec
        both legs) is bitwise equal to the in-process pipeline."""
        cfg = _cfg(kind, graph)
        with DecoupledEngine(graph, cfg, config=_sc()) as local:
            ref = local.infer(TARGETS).embeddings
            with DecoupledEngine(graph, cfg, params=local.params,
                                 config=_sc(transport="inproc")) as remote:
                got = remote.infer(TARGETS).embeddings
                np.testing.assert_array_equal(got, ref)
                s = remote.scheduler.stats
                assert s.rpc_calls == len(TARGETS) // C
                assert s.rpc_bytes_out > 0 and s.rpc_bytes_in > 0
                assert s.rpc_errors == 0
                rpc = s.summary()["rpc"]
                assert rpc["calls"] == s.rpc_calls
                assert remote.nbr_cache is None and remote.sg_cache is None

    def test_socket_transport_in_thread_matches_local(self, graph):
        """SocketTransport against a threaded server in this process:
        real TCP framing, bitwise equal outputs, rpc.* counters."""
        cfg = _cfg("gcn", graph)
        svc = GraphHostService(graph, num_threads=2)
        server = GraphHostServer(svc)
        try:
            sc = _sc(transport="socket", endpoints=(server.endpoint,),
                     rpc_timeout_s=60.0)
            with DecoupledEngine(graph, cfg, config=_sc()) as local:
                ref = local.infer(TARGETS).embeddings
                with DecoupledEngine(graph, cfg, params=local.params,
                                     config=sc) as remote:
                    got = remote.infer(TARGETS).embeddings
                    np.testing.assert_array_equal(got, ref)
                    rep = remote.store_report()
                    hosts = rep["graph_hosts"]
                    assert hosts[0]["healthy"]
                    assert hosts[0]["report"]["requests"] >= 3
                    # remote invalidation drops the graph host's caches
                    assert remote.invalidate(TARGETS[:2]) > 0
        finally:
            server.close()

    def test_two_process_socket_matches_local(self, graph):
        """A graph host in a SEPARATE process serves Select/Build over
        TCP; outputs match in-process bitwise."""
        cfg = _cfg("gcn", graph)
        proc, endpoint = _spawn_graph_host()
        try:
            with DecoupledEngine(graph, cfg, config=_sc()) as local:
                ref = local.infer(TARGETS).embeddings
                with DecoupledEngine(graph, cfg, params=local.params,
                                     config=_sc(
                                         transport="socket",
                                         endpoints=(endpoint,),
                                         rpc_timeout_s=120.0)) as remote:
                    got = remote.infer(TARGETS).embeddings
                    np.testing.assert_array_equal(got, ref)
        finally:
            _stop(proc)


class TestFailureIsolation:
    def test_kill_graph_host_errors_only_inflight_tickets(self, graph):
        """Two graph hosts, no retries: killing one mid-stream errors the
        tickets in flight on it (TransportError), the pool marks it down,
        and every later ticket lands on the survivor."""
        cfg = _cfg("gcn", graph)
        proc_a, ep_a = _spawn_graph_host()
        proc_b, ep_b = _spawn_graph_host()
        eng = DecoupledEngine(graph, cfg, config=_sc(
            transport="socket", endpoints=(ep_a, ep_b), rpc_retries=0,
            rpc_timeout_s=120.0, rpc_concurrency=1))
        try:
            for _ in range(2):          # warm both hosts (round-robin)
                eng.submit_chunk(TARGETS[:C]).result(timeout=120)
            _stop(proc_a)
            tickets = [eng.submit_chunk(TARGETS[:C]) for _ in range(6)]
            outcomes = []
            for t in tickets:
                try:
                    t.result(timeout=120)
                    outcomes.append("ok")
                except TransportError:
                    outcomes.append("err")
            assert "err" in outcomes and "ok" in outcomes
            assert eng.scheduler.stats.rpc_errors >= 1
            after = eng.submit_chunk(TARGETS[:C]).result(timeout=120)
            assert torch.isfinite(after).all()
            healthy = {h["endpoint"]: h["healthy"]
                       for h in eng._host_pool.report()}
            assert healthy[ep_b]
        finally:
            eng.close()
            _stop(proc_a, proc_b)

    def test_retry_reroutes_to_healthy_host(self, graph):
        """With retries enabled, a dead host costs a retry, not a ticket:
        calls fail over to the live host, bitwise the local answer."""
        cfg = _cfg("gcn", graph)
        proc, endpoint = _spawn_graph_host()
        # a dead endpoint: bind+close to get a port nothing listens on
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        eng = DecoupledEngine(graph, cfg, config=_sc(
            transport="socket", endpoints=(dead, endpoint), rpc_retries=1,
            rpc_timeout_s=120.0))
        try:
            out = eng.infer(TARGETS).embeddings
            with DecoupledEngine(graph, cfg, params=eng.params,
                                 config=_sc()) as local:
                np.testing.assert_array_equal(
                    out, local.infer(TARGETS).embeddings)
            st = eng.scheduler.stats
            assert st.rpc_errors == 0 and st.rpc_retries >= 1
        finally:
            eng.close()
            _stop(proc)

    def test_per_call_timeout_raises_rpc_timeout(self):
        """A hung handler trips the per-call deadline as RPCTimeout (a
        TransportError — retryable), and the pool quarantines the
        host."""
        class Stuck:
            def handle(self, request):
                time.sleep(2.0)
                return {"ok": True, "result": None, "remote_s": 2.0}

        server = GraphHostServer(Stuck())
        pool = HostPool([SocketTransport(server.endpoint)],
                        timeout=0.2, retries=0)
        try:
            with pytest.raises(RPCTimeout, match="within 0.2s"):
                pool.call("select_build", {"x": 1})
            assert not pool.report()[0]["healthy"]
        finally:
            pool.close()
            server.close()

    def test_remote_application_error_not_retried(self, graph):
        """A handler exception is a RemoteCallError carrying the remote
        type/message — deterministic, so the pool must NOT burn retries
        on other hosts."""
        svc = GraphHostService(graph, num_threads=1)
        calls = []

        class Counting(InProcTransport):
            def call(self, method, payload, timeout=None):
                calls.append(method)
                return super().call(method, payload, timeout)

        pool = HostPool([Counting(svc), Counting(svc)], retries=2)
        with pytest.raises(RemoteCallError, match="KeyError|missing"):
            pool.call("select_build", {"targets": np.arange(2)})
        assert len(calls) == 1          # no retry
        with pytest.raises(RemoteCallError, match="unknown method"):
            pool.call("no_such_method", None)
        svc.close()

    def test_affine_routing_pins_targets_to_hosts(self, graph):
        svc_a = GraphHostService(graph, num_threads=1)
        svc_b = GraphHostService(graph, num_threads=1)
        pool = HostPool([InProcTransport(svc_a), InProcTransport(svc_b)],
                        routing="affine")
        payload = {"targets": np.asarray([2], np.int64), "n": N,
                   "alpha": 0.15, "eps": 1e-4, "e_pad": 64}
        for _ in range(3):              # affinity 2 -> host index 0
            pool.call("select_build", payload, affinity=2)
        assert svc_a.requests == 3 and svc_b.requests == 0
        for _ in range(2):              # affinity 5 -> host index 1
            pool.call("select_build", payload, affinity=5)
        assert svc_b.requests == 2
        svc_a.close()
        svc_b.close()


def _jparams(kind, jgraph):
    jcfg = _jcfg(kind, jgraph)
    jp = j_init(jcfg, jax.random.PRNGKey(7))
    return jcfg, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu")


class TestAcrossPackages:
    @pytest.mark.parametrize("features", ["dense", "packed"])
    def test_plan_wire_bytes_identical(self, graph, jgraph, features):
        """The host copies are bitwise equal, so the same graph, targets,
        N and e_pad give the same plan, and it encodes to the same bytes
        in both packages."""
        cfg = _cfg("gcn", graph)
        with DecoupledEngine(graph, cfg, config=_sc(
                store=StorePolicy(features=features,
                                  nbr_cache="lru"))) as eng, \
                JEngine(jgraph, _jcfg("gcn", jgraph), config=JConfig(
                    batch_size=C, num_threads=2,
                    store=JPolicy(features=features,
                                  nbr_cache="lru"))) as je:
            assert eng.e_pad == je.e_pad
            mine = wire.encode(wire.plan_to_wire(eng.plan(TARGETS[:C])))
            ref = j_wire.encode(j_wire.plan_to_wire(je.plan(TARGETS[:C])))
        assert mine == ref

    def test_port_engine_with_reference_graph_host(self, graph, jgraph):
        cfg = _cfg("sage", graph)
        server = JServer(JGraphHostService(jgraph, num_threads=2))
        try:
            with DecoupledEngine(graph, cfg, config=_sc()) as local, \
                    DecoupledEngine(graph, cfg, params=local.params,
                                    config=_sc(
                                        transport="socket",
                                        endpoints=(server.endpoint,),
                                        rpc_timeout_s=60.0)) as remote:
                np.testing.assert_array_equal(
                    remote.infer(TARGETS).embeddings,
                    local.infer(TARGETS).embeddings)
                assert remote.scheduler.stats.rpc_calls == 3
        finally:
            server.close()

    def test_reference_engine_with_port_graph_host(self, graph, jgraph):
        jcfg = _jcfg("sage", jgraph)
        server = GraphHostServer(GraphHostService(graph, num_threads=2))
        try:
            with JEngine(jgraph, jcfg, config=JConfig(
                    batch_size=C, num_threads=2)) as local, \
                    JEngine(jgraph, jcfg, params=local.params,
                            config=JConfig(batch_size=C, num_threads=2,
                                           transport="socket",
                                           endpoints=(server.endpoint,),
                                           rpc_timeout_s=60.0)) as remote:
                np.testing.assert_array_equal(
                    np.asarray(remote.infer(TARGETS).embeddings),
                    np.asarray(local.infer(TARGETS).embeddings))
                assert remote.scheduler.stats.rpc_calls == 3
        finally:
            server.close()

    @pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
    def test_port_remote_agrees_with_reference_remote(self, graph, jgraph,
                                                      kind):
        jcfg, jp, tp = _jparams(kind, jgraph)
        with JEngine(jgraph, jcfg, params=jp, config=JConfig(
                batch_size=C, num_threads=2, transport="inproc")) as je, \
                DecoupledEngine(graph, _cfg(kind, graph), params=tp,
                                config=_sc(transport="inproc")) as te:
            want = np.asarray(je.infer(TARGETS).embeddings)
            got = te.infer(TARGETS).embeddings
            # the same requests cross the wire (the replies differ only
            # in the handler times they report)
            assert te.scheduler.stats.rpc_bytes_out \
                == je.scheduler.stats.rpc_bytes_out
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


class TestRepairs:
    def test_pack_recomputes_density_of_a_wire_plan(self, graph):
        """A plan decoded from the wire carries rows but no density: Pack
        fills n_vertices and n_edges with what Build would have set."""
        with DecoupledEngine(graph, _cfg("gcn", graph),
                             config=_sc()) as eng:
            sel, build, pack = eng.stages
            built = build.run(sel.run(BatchPlan(targets=TARGETS[:C])))
            assert built.n_edges is not None
            for plan in (dataclasses.replace(built, n_vertices=None,
                                             n_edges=None),
                         wire.plan_from_wire(wire.decode(wire.encode(
                             wire.plan_to_wire(built))))):
                assert plan.n_vertices is None and plan.n_edges is None
                out = pack.run(plan)
                assert (out.n_vertices, out.n_edges) \
                    == (built.n_vertices, built.n_edges)
            assert isinstance(pack, PackStage)
            assert eng.scheduler.stats.batch_edges == built.n_edges

    def test_adaptive_engine_behind_inproc_decides_as_local(self, graph):
        """Behind the transport Build's density does not cross the wire;
        Pack's recompute feeds dispatch, so the remote adaptive engine
        takes the local one's decisions and serves its bits."""
        cfg = _cfg("gcn", graph)
        costs = {"dense": 1.0, "sg": 1e-6}
        out = {}
        for transport in ("local", "inproc"):
            with DecoupledEngine(graph, cfg, config=_sc(
                    transport=transport, dispatch=DispatchConfig(
                        warmup_passes=0, autotune_blocks=False))) as eng:
                # a table that prices every sg step cheapest
                plan = eng.plan(TARGETS[:C])
                bucket = size_bucket(plan.device)
                sites = mux_sites(eng.program)
                for sec, _ in eng.program.layer_sections():
                    for mode, cost in costs.items():
                        seq = getattr(respecialize(eng.program, {
                            s: mode for s in sites if s.startswith(sec)}),
                            sec)
                        for ops_, _ in compile_steps(seq, "torch"):
                            eng.dispatch.table.record(
                                "+".join(type(o).__name__ for o in ops_),
                                f"torch/{mode}", bucket, cost)
                eng.run_device(plan)
                emb = eng.infer(TARGETS).embeddings
                out[transport] = (emb, eng.dispatch_report(),
                                  eng.scheduler.stats.batch_edges,
                                  eng.dispatch._measured_assignment(bucket))
        (a, ra, ea, da), (b, rb, eb, db) = out["local"], out["inproc"]
        np.testing.assert_array_equal(a, b)
        assert rb["decisions"] == ra["decisions"] == 1 + len(TARGETS) // C
        assert rb["sources"] == ra["sources"]
        assert db == da and set(da.values()) == {"sg"}
        assert eb == ea > 0

    def test_traced_remote_engine_stitches_host_spans(self, graph,
                                                      tmp_path):
        cfg = _cfg("gcn", graph)
        with DecoupledEngine(graph, cfg, config=_sc()) as local:
            ref = local.infer(TARGETS).embeddings
            with DecoupledEngine(graph, cfg, params=local.params,
                                 config=_sc(transport="inproc",
                                            trace=TraceConfig())) as eng:
                got = eng.infer(TARGETS).embeddings
                rep = eng.trace_report()
                tree = eng.export_trace(str(tmp_path / "remote.json"))
                spans = eng.tracer.export_spans()
        np.testing.assert_array_equal(got, ref)
        assert validate_chrome_trace(tree) == []
        assert rep["remote_spans"] > 0
        assert set(rep["clock_sync"]) == {"inproc"}
        remote = [s for s in spans if s["cat"] == "remote"]
        assert {s["name"] for s in remote} == {"remote.select",
                                              "remote.build"}
        rpc = {s["span_id"]: s for s in spans if s["name"] == "select_build"}
        assert all(s["parent_id"] in rpc for s in remote)
