"""The coupled baseline and Algorithm 1's oracle in the PyTorch package
(``repro_torch.core.coupled``, a numpy copy) against the reference's, and
the paper's equivalence run through the port: over the FULL L-hop
receptive field with readout='target', decoupled inference equals the
message-passing recursion (tests/test_gnn_core.py's case, here through
the port's ``gnn_forward`` under impl="torch" and impl="cuda", whose
kernels take their plain versions on the CPU).

Tolerances: the oracle's functions are a copy over the same graph, so the
hop sets, receptive-field sizes and cost model are held bitwise; the
equivalence at the reference test's rtol 2e-4, atol 2e-5 (fp32 dense
program against the fp64 recursion)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import coupled as j_coupled  # noqa: E402
from repro.graphs.csr import from_edge_list as j_from_edge_list  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro_torch.core import coupled as t_coupled  # noqa: E402
from repro_torch.core.subgraph import batch_from_node_lists  # noqa: E402
from repro_torch.gnn.model import GNNConfig, gnn_forward, init_gnn  # noqa
from repro_torch.graphs.csr import from_edge_list  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402


def small_graph(n, seed, extra_edges=2, build=from_edge_list):
    """tests/test_gnn_core.py's random connected-ish graph."""
    rng = np.random.default_rng(seed)
    src = np.arange(1, n)
    dst = rng.integers(0, np.maximum(src, 1))
    e_src = rng.integers(0, n, size=n * extra_edges)
    e_dst = rng.integers(0, n, size=n * extra_edges)
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    return build(np.concatenate([src, e_src]), np.concatenate([dst, e_dst]),
                 n, feats)


@pytest.fixture(scope="module")
def graphs():
    return (get_graph("flickr", scale=0.02, seed=1),
            j_get_graph("flickr", scale=0.02, seed=1))


class TestCopy:
    @pytest.mark.parametrize("L", [1, 2, 3])
    @pytest.mark.parametrize("fanouts", [None, (5, 3, 2)])
    def test_lhop_nodes(self, graphs, L, fanouts):
        tg, jg = graphs
        for target in (0, 7, 123):
            assert np.array_equal(
                t_coupled.lhop_nodes(tg, target, L, fanouts, seed=3),
                j_coupled.lhop_nodes(jg, target, L, fanouts, seed=3))

    @pytest.mark.parametrize("fanouts", [None, (4, 4, 4)])
    def test_receptive_field_and_cost_model(self, graphs, fanouts):
        tg, jg = graphs
        targets = list(range(8))
        for L in (1, 2, 3):
            assert t_coupled.receptive_field_size(tg, targets, L, fanouts) \
                == j_coupled.receptive_field_size(jg, targets, L, fanouts)
        assert t_coupled.coupled_cost_model(tg, targets, 2, 256, fanouts) \
            == j_coupled.coupled_cost_model(jg, targets, 2, 256, fanouts)

    @pytest.mark.parametrize("kind", ["gcn", "sage"])
    def test_oracle_equals_reference_oracle(self, kind):
        """Both oracles on one graph and one parameter tree (numpy for the
        reference, the port's tensors for the port): fp64 recursions of
        the same loops, bitwise."""
        cfg = GNNConfig(kind=kind, n_layers=2, receptive_field=64, f_in=8,
                        f_hidden=16, readout="target")
        params = init_gnn(cfg, seed=2, device="cpu")
        as_np = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.numpy())
                 for k, v in params.items()}
        tg = small_graph(60, 4)
        jg = small_graph(60, 4, build=j_from_edge_list)
        for target in (0, 5, 33):
            got = t_coupled.coupled_reference_embedding(tg, target, 2,
                                                        params, kind)
            want = j_coupled.coupled_reference_embedding(jg, target, 2,
                                                         as_np, kind)
            assert np.array_equal(got, want)

    def test_gcn_norm_weights(self):
        nodes = np.arange(5)
        src, dst = np.array([0, 1, 1, 3]), np.array([1, 2, 0, 2])
        assert np.array_equal(
            t_coupled._gcn_norm_weights(nodes, src, dst),
            j_coupled._gcn_norm_weights(nodes, src, dst))


class TestDecoupledVsCoupled:
    @pytest.mark.parametrize("impl", ["torch", "cuda"])
    @pytest.mark.parametrize("kind", ["gcn", "sage"])
    @pytest.mark.parametrize("L", [1, 2, 3])
    def test_equivalence(self, kind, L, impl):
        g = small_graph(80, seed=L * 7 + (kind == "sage"))
        tgt = 5
        nodes = t_coupled.lhop_nodes(g, tgt, L)
        npad = int(max(8, 1 << int(np.ceil(np.log2(len(nodes))))))
        cfg = GNNConfig(kind=kind, n_layers=L, receptive_field=npad,
                        f_in=g.feature_dim, f_hidden=16, readout="target")
        params = init_gnn(cfg, seed=L, device="cpu")
        sb = batch_from_node_lists(g, [tgt], [nodes], npad,
                                   max(1, npad * (npad - 1)))
        assert sb.edges_dropped == 0
        b = {k: torch.from_numpy(getattr(sb, k))
             for k in ("feats", "adj", "adj_mean", "mask")}
        emb, _ = gnn_forward(cfg, params, b, impl=impl)
        ref = t_coupled.coupled_reference_embedding(g, tgt, L, params, kind)
        np.testing.assert_allclose(emb.numpy()[0], ref, rtol=2e-4,
                                   atol=2e-5)
