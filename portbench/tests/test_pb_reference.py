"""The plain reference and the frozen inputs against the port on the
CPU: the graph bitwise the port's generator's, Select and Build equal to
the port's, and tiny runs of every cell through the port under
impl="torch" judged correct by the reference."""
import numpy as np
import pytest
import torch

from portbench import graphgen, load, reference
from portbench.reference.ppr import select
from portbench.reference.subgraph import gcn_norm, induced_adjacency
from portbench.tests.tiny import run_tiny
from repro_torch.core.ini import select_important
from repro_torch.core.subgraph import build_subgraph_rows
from repro_torch.graphs import synthetic

N_VERT = 3000


@pytest.fixture(scope="module")
def graphs():
    scale = N_VERT / synthetic.FLICKR.num_vertices
    port = synthetic.make_graph(synthetic.FLICKR, scale=scale, seed=2**33)
    mine = graphgen.make_graph(graphgen.GraphSpec(
        port.num_vertices, 10.0, 500, 7), 2**33)
    return port, mine


def test_graph_is_bitwise_the_port_generators(graphs):
    port, mine = graphs
    assert np.array_equal(port.indptr, mine.indptr)
    assert np.array_equal(port.indices, mine.indices)
    assert np.array_equal(port.features, mine.features)
    top = graphgen.ranked(mine, 64)
    assert np.array_equal(top, np.argsort(-port.degrees, kind="stable")[:64])


def test_traffic_draws_as_the_port_s_zipf_traffic(graphs):
    """Over every vertex, the generator's draws are ``zipf_traffic``'s:
    Zipf(1.1) over popularity ranks, ranked by degree."""
    port, mine = graphs
    rng = np.random.default_rng(2**31 + 9)
    got = load.zipf_targets(graphgen.ranked(mine), 1.1, 5000, rng)
    want = synthetic.zipf_traffic(port, 5000, a=1.1, seed=2**31 + 9)
    assert np.array_equal(got, want)
    assert len(np.unique(got)) > 1000       # the tail, not a hot set


def test_select_and_build_match_the_port(graphs):
    port, mine = graphs
    for t in graphgen.ranked(mine, 40)[::3]:
        nodes = select(mine.indptr, mine.indices, int(t), 32, 0.15, 1e-4)
        assert np.array_equal(nodes, select_important(port, int(t), 32))
        rows = build_subgraph_rows(port, nodes, 32)
        k = len(nodes)
        a = torch.from_numpy(induced_adjacency(mine.indptr, mine.indices,
                                               nodes))
        assert np.allclose(gcn_norm(a).numpy(), rows.adj[:k, :k],
                           rtol=1e-6, atol=0)
        assert np.array_equal(a.numpy() > 0, rows.adj_mean[:k, :k] > 0)


def test_reference_blocks_do_not_change_the_answer(graphs):
    _, mine = graphs
    cfg = {"reference": "gcn", "receptive_field": 16, "ppr_alpha": 0.15,
           "ppr_eps": 1e-4, "n_layers": 2}
    gen = torch.Generator().manual_seed(0)
    params = {"layer0": {"w": torch.randn(500, 8, generator=gen),
                         "b": torch.randn(8, generator=gen)},
              "layers": {"w": torch.randn(1, 8, 8, generator=gen),
                         "b": torch.randn(1, 8, generator=gen)}}
    sgs = reference.build(mine, cfg, graphgen.ranked(mine, 10))
    whole = reference.embed(mine, cfg, params, sgs, "cpu", block=10)
    parts = reference.embed(mine, cfg, params, sgs, "cpu", block=3)
    assert np.allclose(whole, parts, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("workload,loop", [
    ("gcn-l16-c512-zipf-closed", "closed"),
    ("gat-l16-c512-zipf-closed", "closed"),
    ("gcn-l16-c512-zipf-closed", "open")])
def test_tiny_run_of_the_port_is_correct(workload, loop):
    result, _, checks = run_tiny(workload, loop=loop)
    gaps = {c.name: c.value for c in checks}
    assert result["correct"], gaps
    assert gaps["never_came"] == 0 and gaps["emb_gap"] < 1e-5
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_fixed_structure_is_relabelled_by_the_run_seed(graphs):
    """With ``structure_seed`` set, every run seed gets the same graph with
    its vertices renumbered: the same degrees, edges and features under
    the seed's permutation; the same seed, the same graph."""
    _, mine = graphs
    a, b = graphgen.relabel(mine, 2**33 + 1), graphgen.relabel(mine, 2**33 + 2)
    again = graphgen.relabel(mine, 2**33 + 1)
    assert np.array_equal(a.indices, again.indices)
    assert not np.array_equal(a.indices, b.indices)
    perm = np.random.default_rng([2**33 + 1, 11]).permutation(
        mine.num_vertices)
    assert np.array_equal(a.degrees[perm], mine.degrees)
    assert np.array_equal(a.features[perm], mine.features)
    for v in (0, 7, int(np.argmax(mine.degrees))):
        got = a.indices[a.indptr[perm[v]]:a.indptr[perm[v] + 1]]
        want = np.sort(perm[mine.indices[mine.indptr[v]:mine.indptr[v + 1]]])
        assert np.array_equal(got, want)
    assert np.array_equal(np.sort(a.degrees), np.sort(b.degrees))
