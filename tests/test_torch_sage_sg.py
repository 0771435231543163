"""GraphSAGE on the scatter-gather datapath: the port's engine and server
against the plain reference the benchmark judges by
(``portbench/reference/sage.py``), on seeded weights at a small size; no
edge dropped (Build keeps a clique denser than the old default budget
whole, a budget exceeded raises and is counted); Pack's edge slots follow
each batch's largest subgraph and an sg batch ships no [C, N, N] matrix;
the row cache counts each entry's real bytes; rows cross the wire at the
deployment's fixed layout and a row a graph host cut is refused; the
engine stacks [W_neigh; W_self] once; traced == untraced bitwise. On a card
(marker ``gpu``): the sg Aggregate at the benchmark cell's shapes against
``scatter_gather_aggregate_ref``, the stacked Transform against the plain
one, and a traced engine's ``gpu.aggregate`` spans and shape counters."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import reference  # noqa: E402
from portbench.serving import make_params  # noqa: E402
from repro_torch.core import subgraph  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.core.program import stacked_key  # noqa: E402
from repro_torch.core.subgraph import (EdgeBudgetError,  # noqa: E402
                                       build_batch, build_subgraph_rows,
                                       default_edge_pad, edge_slots)
from repro_torch.distributed import wire  # noqa: E402
from repro_torch.gnn.model import GNNConfig  # noqa: E402
from repro_torch.graphs.csr import CSRGraph  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.obs import TraceConfig  # noqa: E402
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402
from repro_torch.store import StorePolicy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, C, L, F = 32, 4, 3, 16
TARGETS = np.array([0, 5, 9, 31, 77, 101, 3, 2, 5, 0])


def _cfg(g, n=N, layers=L):
    """The benchmark's form of the model (what ``make_params`` and the
    reference read)."""
    return {"reference": "sage", "kind": "sage", "n_layers": layers,
            "receptive_field": n, "f_in": g.feature_dim, "f_hidden": F,
            "readout": "max", "ppr_alpha": 0.15, "ppr_eps": 1e-4,
            "weights": {"gain": 1.0, "bias_std": 0.1}}


def _engine(g, params, n=N, layers=L, **kw):
    conf = dict(device="cpu", batch_size=C, mode="sg", impl="cuda",
                e_pad=n * (n - 1), num_threads=1)
    conf.update(kw)
    return DecoupledEngine(g, GNNConfig(kind="sage", n_layers=layers,
                                        receptive_field=n,
                                        f_in=g.feature_dim, f_hidden=F),
                           params=params, config=ServingConfig(**conf))


def _reference(g, cfg, params, targets):
    subs = reference.build(g, cfg, targets)
    return reference.embed(g, cfg, params, subs, "cpu")


def clique_graph(n: int, path: int = 2000, f: int = 8) -> CSRGraph:
    """An n-clique (vertices 0..n-1) beside a path of ``path`` vertices:
    the clique's every induced subgraph of n vertices has n(n-1) edges,
    while the mean degree stays low, so the default edge budget (4 N x
    the mean degree, at least 4) is smaller than the clique."""
    src, dst = [], []
    for u in range(n):
        for v in range(n):
            if u != v:
                src.append(u)
                dst.append(v)
    for u in range(n, n + path - 1):
        src += [u, u + 1]
        dst += [u + 1, u]
    src, dst = np.asarray(src), np.asarray(dst)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    v = n + path
    indptr = np.zeros(v + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=v))
    feats = np.random.default_rng(0).standard_normal((v, f)) \
        .astype(np.float32)
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32),
                    features=feats, name="clique").validate()


@pytest.fixture(scope="module")
def graph():
    return get_graph("flickr", scale=0.02, seed=1)


@pytest.fixture(scope="module")
def clique():
    return clique_graph(N)


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import portbench.reference.sage; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("mode", ["sg", "dense"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_engine_matches_the_reference(graph, impl, mode):
    """The port (its plain twin, impl="torch", and the kernels' path,
    impl="cuda", whose wrappers run their plain versions on the CPU) on
    the weights the benchmark draws, against the plain reference."""
    cfg = _cfg(graph)
    params = make_params(cfg, 7, "cpu")
    with _engine(graph, params, mode=mode, impl=impl) as eng:
        got = eng.infer(TARGETS).embeddings
    want = _reference(graph, cfg, params, TARGETS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_server_matches_the_reference(graph):
    """End to end: requests through ``GNNServer`` (its lane's batches,
    the pipelined stages, the sg program on the kernels' path)."""
    cfg = _cfg(graph)
    params = make_params(cfg, 11, "cpu")
    eng = _engine(graph, params)
    srv = GNNServer(eng, max_wait_s=0.005)
    srv.start()
    try:
        reqs = [srv.submit(int(t)) for t in TARGETS]
        srv.drain(reqs, timeout=120)
    finally:
        srv.stop()
        eng.close()
    assert all(r.error is None for r in reqs)
    got = np.stack([np.asarray(r.embedding) for r in reqs])
    want = _reference(graph, cfg, params, TARGETS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


class TestNoEdgeDropped:
    @pytest.mark.parametrize("e_pad", [None, N * (N - 1)])
    def test_a_clique_over_the_old_default_budget_arrives_whole(self,
                                                                clique,
                                                                e_pad):
        """Build keeps all n(n-1) edges of a clique denser than
        default_edge_pad (which cut them before), with no budget set or
        with N(N-1): none counted dropped, Pack ships every one, and the
        served answer is the reference's."""
        e = N * (N - 1)
        assert e > default_edge_pad(clique, N)
        cfg = _cfg(clique)
        params = make_params(cfg, 3, "cpu")
        targets = np.array([0, 1, 2, 3])
        with _engine(clique, params, e_pad=e_pad) as eng:
            plan = eng.plan(targets)
            got = eng.infer(targets).embeddings
        for r in plan.rows:
            assert r.n_edges == e and len(r.edge_src) == e
            assert r.edges_dropped == 0
        assert plan.sb.edges_dropped == 0
        assert (plan.device["edge_w_mean"] != 0).sum(1).tolist() == [e] * C
        np.testing.assert_allclose(
            plan.device["edge_w_mean"].sum(1), np.full(C, float(N)),
            rtol=1e-5)
        np.testing.assert_allclose(
            got, _reference(clique, cfg, params, targets), rtol=1e-5,
            atol=1e-6)

    @pytest.mark.parametrize("where", ["build_rows", "build_batch",
                                       "engine", "wire"])
    def test_a_budget_exceeded_raises(self, clique, where):
        """Over its budget a subgraph is refused (and counted), never
        cut: by ``build_subgraph_rows`` and ``build_batch`` given the
        budget, by an sg engine's Pack at a configured ``e_pad``, and, for
        a row a graph host cut (``edges_dropped`` > 0), by
        ``rows_from_wire``."""
        nodes = np.arange(N)
        before = (subgraph.edges_refused, subgraph.subgraphs_refused)
        with pytest.raises(EdgeBudgetError, match="edge budget"):
            if where == "build_rows":
                build_subgraph_rows(clique, nodes, N, N * (N - 1) - 1)
            elif where == "build_batch":
                build_batch(clique, [0], N, e_pad=N * (N - 1) - 1,
                            num_threads=1)
            elif where == "wire":
                d = wire.rows_to_wire([build_subgraph_rows(clique, nodes,
                                                           N)])
                d["n_edges"][0] -= 10          # a host's cut at its budget
                d["edges_dropped"][0] = 10
                wire.rows_from_wire(wire.decode(wire.encode(d)))
            else:
                params = make_params(_cfg(clique), 3, "cpu")
                with _engine(clique, params, e_pad=900) as eng:
                    eng.plan(np.array([0, 1, 2, 3]))
        assert subgraph.edges_refused - before[0] == N * (N - 1)
        assert subgraph.subgraphs_refused - before[1] == 1

    def test_a_dense_engine_needs_no_budget(self, clique):
        """A deployment that ships no edge layout keeps every edge in its
        adjacency at the default budget and refuses nothing."""
        params = make_params(_cfg(clique), 3, "cpu")
        with _engine(clique, params, e_pad=None, mode="dense") as eng:
            plan = eng.plan(np.array([0, 1, 2, 3]))
        assert [r.n_edges for r in plan.rows] == [N * (N - 1)] * C
        assert (plan.device["adj_mean"] > 0).sum((1, 2)).tolist() \
            == [N * (N - 1)] * C
        assert "edge_src" not in plan.device
        assert plan.sb.edge_src.shape == (C, 0)


class TestPack:
    @pytest.mark.parametrize("e_pad,clique_slots", [(4096, 3072),
                                                     (48 * 47, 48 * 47)])
    def test_edge_slots_follow_the_largest_subgraph(self, e_pad,
                                                    clique_slots):
        """A batch's edge layout takes its largest subgraph's edges
        rounded up to 1,024, at most the budget; the counters add its
        real edges and slots; an sg batch ships no [C, N, N] matrix."""
        n = 48
        g = clique_graph(n)
        params = make_params(_cfg(g, n), 3, "cpu")
        with _engine(g, params, n=n, e_pad=e_pad) as eng:
            dense = eng.plan(np.array([0, 1, 0, 2]))
            sparse = eng.plan(np.array([n + 5, n + 100, n + 500, n + 7]))
            st = eng.scheduler.stats
            edges, slots = st.edges_shipped, st.edge_slots_shipped
        assert dense.device["edge_src"].shape == (C, clique_slots)
        assert sparse.device["edge_src"].shape == (C, 1024)
        most = max(r.n_edges for r in sparse.rows)
        assert most < 1024 and edge_slots([most], e_pad) == 1024
        for plan in (dense, sparse):
            assert not {"adj", "adj_mean"} & set(plan.device)
            assert plan.sb.adj.shape == (C, 0, 0)
            e = plan.device["edge_src"].shape[1]
            for i, r in enumerate(plan.rows):
                k = r.n_edges
                assert np.array_equal(plan.device["edge_src"][i, :k],
                                      r.edge_src)
                assert (plan.device["edge_w_mean"][i, k:] == 0).all()
                assert (plan.device["edge_src"][i, k:] == n - 1).all()
                assert e >= k
        assert edges == sum(r.n_edges for p in (dense, sparse)
                            for r in p.rows)
        assert slots == C * (clique_slots + 1024)

    @pytest.mark.parametrize("e_pad,slots", [(None, 1024),
                                             (N * (N - 1), N * (N - 1)),
                                             (5000, 1024)])
    def test_build_batch_lays_out_its_largest_subgraph(self, clique, e_pad,
                                                       slots):
        """The library's ``build_batch`` takes the same edge slots as
        Pack: the largest subgraph's edges rounded up to 1,024, at most
        the budget, every edge kept."""
        sb = build_batch(clique, [0, 1, N + 3], N, e_pad=e_pad,
                         num_threads=1)
        assert sb.edge_src.shape == (3, slots)
        assert sb.n_edges[:2].tolist() == [N * (N - 1)] * 2
        assert (sb.edge_w_mean != 0).sum(1).tolist() == sb.n_edges.tolist()

    def test_edge_slots_rounding(self):
        assert edge_slots([], None) == 1024
        assert edge_slots([0, 3], 64) == 64
        assert edge_slots([1024, 7], None) == 1024
        assert edge_slots([1025], None) == 2048
        assert edge_slots([1025], 1500) == 1500
        with pytest.raises(EdgeBudgetError):
            edge_slots([1501], 1500)


class TestRowCache:
    def test_entries_hold_and_count_their_real_edges(self, graph):
        """Rows cached at their real edge count, counted at their bytes
        against the byte budget (no entry cap given)."""
        params = make_params(_cfg(graph), 3, "cpu")
        budget = 6 * (2 * N * N * 4 + 2 * N * 4)
        with _engine(graph, params, store=StorePolicy(
                nbr_cache="lru", subgraph_budget_bytes=budget)) as eng:
            eng.infer(np.arange(40))
            cache = eng.sg_cache
            entries = [ent[0] for ent in cache._lru.values()]
            assert 0 < len(entries) < 40 and cache.evictions > 0
            assert cache.nbytes == sum(r.nbytes for r in entries)
            assert cache.nbytes <= budget
            for r in entries:
                assert len(r.edge_src) == len(r.edge_w_mean) == r.n_edges

    def test_byte_bound_evicts_and_invalidation_releases(self):
        from repro_torch.store.nbr_cache import SubgraphRowCache
        g = clique_graph(8, path=40)
        rows = [build_subgraph_rows(g, np.arange(k), 8)
                for k in (8, 6, 4)]
        cache = SubgraphRowCache(10, max_bytes=rows[0].nbytes
                                 + rows[1].nbytes)
        for i, r in enumerate(rows):
            cache.put((i, 8, 0.15, 1e-4), r, frontier=np.arange(8))
        assert len(cache) == 2 and cache.evictions == 1
        assert cache.nbytes == rows[1].nbytes + rows[2].nbytes
        cache.invalidate([0])
        assert len(cache) == 0 and cache.nbytes == 0


def test_rows_cross_the_wire_at_the_fixed_layout(clique):
    """Rows at their real edge count take the deployment's e_pad slots on
    the wire (the layout the reference's hosts ship) and come back at
    their real count."""
    rows = [build_subgraph_rows(clique, np.arange(k), N)
            for k in (N, 5)]
    d = wire.rows_to_wire(rows, 1100)
    assert d["edge_src"].shape == (2, 1100)
    assert (d["edge_dst"][1, rows[1].n_edges:] == N - 1).all()
    back = wire.rows_from_wire(wire.decode(wire.encode(d)))
    for a, b in zip(rows, back):
        for f in ("edge_src", "edge_dst", "edge_w", "edge_w_mean", "adj"):
            assert np.array_equal(getattr(a, f), getattr(b, f))


def test_the_engine_stacks_the_self_weights_once(graph):
    """Under impl="cuda" the engine places [W_neigh; W_self] beside the
    two weights, layer 0 (its rows padded to f_pad) and the stacked inner
    layers alike, and the program on params without the stack serves the
    same bits."""
    params = make_params(_cfg(graph), 5, "cpu")
    with _engine(graph, params) as eng:
        op = next(op for op in eng.program.layer0 if
                  getattr(op, "w_self", None))
        key = stacked_key(op)
        l0, inner = eng.params["layer0"], eng.params["layers"]
        assert l0[key].shape[0] == 2 * eng.f_pad
        assert torch.equal(l0[key], torch.cat((l0[op.w], l0[op.w_self])))
        assert torch.equal(inner[key], torch.cat(
            (inner[op.w], inner[op.w_self]), dim=1))
        batch = eng.device_batch(eng.plan(TARGETS[:C]).sb)
        got = eng.run_device(batch)
        eng.params = {k: {n: v for n, v in d.items() if n != key}
                      if isinstance(d, dict) else d
                      for k, d in eng.params.items()}
        want = eng.run_device(batch)
    assert torch.equal(got, want)


def test_traced_serves_the_untraced_bits(graph):
    params = make_params(_cfg(graph), 5, "cpu")
    out = []
    for traced in (False, True):
        with _engine(graph, params) as eng:
            if traced:
                eng.attach_tracer(TraceConfig())
            out.append(eng.infer(TARGETS).embeddings)
    np.testing.assert_array_equal(out[0], out[1])


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cell_edges(rng, c, n, slots, mean_edges):
    """An sg batch like the benchmark cell's: c subgraphs of n vertices,
    each with about ``mean_edges`` real edges (Poisson, at most the
    slots), mean weights 1 / in-degree, padding at n - 1 with weight 0."""
    src = np.full((c, slots), n - 1, np.int32)
    dst = np.full((c, slots), n - 1, np.int32)
    w = np.zeros((c, slots), np.float32)
    for i in range(c):
        e = min(slots, int(rng.poisson(mean_edges)))
        s = rng.integers(0, n, e)
        d = rng.integers(0, n, e)
        indeg = np.bincount(d, minlength=n).astype(np.float32)
        src[i, :e], dst[i, :e] = s, d
        w[i, :e] = 1.0 / indeg[d]
    return src, dst, w


@pytest.mark.gpu
@pytest.mark.parametrize("f", [256, 512])
def test_sg_aggregate_at_the_cell_shape(dev, f):
    """C=512, N=256, the cell's per-batch edge slots (12,288, ~5.5k real
    edges a subgraph): the kernel against ``scatter_gather_aggregate_ref``
    at the fp32 tolerance, bitwise repeatable, counted by shape."""
    from repro_torch.kernels import ops, scatter_gather
    rng = np.random.default_rng(0)
    c, n, e = 512, 256, 12288
    src, dst, w = (torch.from_numpy(a).to(dev)
                   for a in _cell_edges(rng, c, n, e, 5500))
    h = torch.randn(c, n, f, device=dev)
    ops.reset_launch_counts()
    got = scatter_gather.scatter_gather_aggregate(src, dst, w, h)
    again = scatter_gather.scatter_gather_aggregate(src, dst, w, h)
    want = scatter_gather.scatter_gather_aggregate_ref(src, dst, w, h)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, again)
    assert scatter_gather.shape_launches == {("sort", c, n, e, f): 2}


@pytest.mark.gpu
@pytest.mark.parametrize("f_in", [512, 256])
def test_stacked_transform_on_tf32x3(dev, f_in):
    """The sg Transform's one self-only launch on [z | h] and [W_neigh;
    W_self] against the plain two products, at C=512, N=256."""
    gen = torch.Generator(device=dev).manual_seed(0)
    c, n, fo = 512, 256, 256
    z, h = (torch.randn(c, n, f_in, device=dev, generator=gen)
            for _ in range(2))
    wn, ws = (torch.randn(f_in, fo, device=dev, generator=gen)
              / f_in ** 0.5 for _ in range(2))
    b = torch.randn(fo, device=dev, generator=gen)
    mask = torch.ones(c, n, device=dev)
    mask[:, 200:] = 0
    before = dict(fused_gnn.variant_launches)
    got = fused_gnn.fused_gnn_layer(None, torch.cat((z, h), -1), None,
                                    torch.cat((wn, ws)), b, mask)
    assert fused_gnn.variant_launches["tf32x3"] == before["tf32x3"] + 1
    want = torch.relu(z @ wn + h @ ws + b) * mask[..., None]
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_traced_engine_spans_each_sg_aggregate(dev):
    """A traced sage/sg engine on the card: one ``gpu.aggregate`` span a
    layer inside each batch, one scatter-gather launch a layer counted
    by shape, one tf32x3 launch a layer, the untraced bits served."""
    from repro_torch.kernels import ops, scatter_gather
    g = get_graph("flickr", scale=0.02, seed=1)
    n, layers = 64, 3
    params = make_params(_cfg(g, n, layers), 5, "cuda")
    targets = np.arange(16)
    out = []
    for traced in (False, True):
        with _engine(g, params, n=n, layers=layers, device="cuda") as eng:
            tr = eng.attach_tracer(TraceConfig()) if traced else None
            ops.reset_launch_counts()
            out.append(eng.infer(targets).embeddings)
            if traced:
                totals = tr.totals()
    batches = len(targets) // C
    assert totals["gpu.aggregate"][0] == batches * layers
    assert sum(scatter_gather.shape_launches.values()) == batches * layers
    assert fused_gnn.variant_launches["tf32x3"] == batches * layers
    np.testing.assert_array_equal(out[0], out[1])
