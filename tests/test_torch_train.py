"""GNN training in the PyTorch package against the reference on the CPU:
the AdamW update (``train.optim``), the training loss's gradients, one
``make_gnn_train_step`` step, the optimizer state carried across, and
``train_gnn`` lowering the loss. Inputs come from numpy seeds (the graph,
the batch, the labels) and the reference's parameters are carried across
by ``params_from_jax``.

Held separately, because AdamW's first step is sign-like (m_hat /
(sqrt(v_hat) + eps) ~ +-1 wherever |g| >> eps): a gradient element whose
sign differed between the frameworks by rounding would move its parameter
by 2 lr, so whole trajectories are not compared element by element.
- the optimizer on identical params, grads and state, three steps: rtol
  1e-5 (fp32 update math on both sides, in other fused orders);
- the gradients: atol 1e-5 x each leaf's largest |g| (fp32 sums in other
  orders through L layers; the reference test's 1e-4 relative for three
  layers' forward, tests/test_torch_program.py, is looser);
- loss and grad_norm: rtol 1e-5; acc: within one target of the batch (an
  argmax near-tie may break either way).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.subgraph import build_batch as j_build_batch  # noqa: E402
from repro.gnn.model import GNNConfig as JGNN  # noqa: E402
from repro.gnn.model import gnn_forward as j_forward  # noqa: E402
from repro.gnn.model import init_gnn as j_init  # noqa: E402
from repro.gnn.train import make_gnn_train_step as j_make_step  # noqa: E402
from repro.graphs.synthetic import get_graph as j_get_graph  # noqa: E402
from repro.train import optim as j_optim  # noqa: E402
from repro_torch.gnn import train as t_train  # noqa: E402
from repro_torch.gnn.model import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.train import optim as t_optim  # noqa: E402

KINDS = ("gcn", "sage", "gin", "gat")
N, C, L, F_HID = 32, 8, 3, 16
OPT_RTOL = 1e-5
GRAD_ATOL = 1e-5
METRIC_RTOL = 1e-5


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def graph():
    return j_get_graph("flickr", scale=0.02, seed=1)


@pytest.fixture(scope="module")
def batch(graph):
    """A training batch as numpy (the reference's build), its labels."""
    targets = np.random.default_rng(4).integers(0, graph.num_vertices, C)
    sb = j_build_batch(graph, targets, N, num_threads=4)
    b = {k: getattr(sb, k) for k in t_train.BATCH_KEYS}
    return b, graph.labels[targets].astype(np.int64)


def _cfgs(kind, graph):
    kw = dict(kind=kind, n_layers=L, receptive_field=N,
              f_in=graph.feature_dim, f_hidden=F_HID,
              num_classes=int(graph.labels.max()) + 1)
    return JGNN(**kw), GNNConfig(**kw)


def _j_loss(cfg, params, batch, labels):
    """The reference step's loss_fn (a closure of make_gnn_train_step)."""
    logits, _ = j_forward(cfg, params, batch, mode="dense")
    lp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(lp, labels[:, None], axis=-1)[:, 0]
    acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
    return nll.mean(), acc


def _tree(rng, scale=1.0):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32) * scale,
            "b": rng.standard_normal((3,)).astype(np.float32) * scale,
            "eps": np.float32(rng.standard_normal() * scale),
            "layers": {"m": rng.standard_normal((2, 3, 2)).astype(
                np.float32) * scale}}


class TestAdamW:
    @pytest.mark.parametrize("moments", ["float32", "bfloat16"])
    def test_three_steps_match_reference(self, moments):
        rng = np.random.default_rng(0)
        params = _tree(rng)
        jcfg = j_optim.AdamWConfig(lr=1e-2, weight_decay=0.1,
                                   grad_clip=2.0, moment_dtype=moments)
        tcfg = t_optim.AdamWConfig(lr=1e-2, weight_decay=0.1,
                                   grad_clip=2.0, moment_dtype=moments)
        jp = jax.tree.map(jnp.asarray, params)
        tp = _t(params)
        js, ts = j_optim.init_opt(jp, jcfg), t_optim.init_opt(tp, tcfg)
        assert ts.m["w"].dtype == getattr(torch, moments)
        for step in range(3):
            grads = _tree(rng, scale=3.0 if step == 0 else 0.5)
            jp, js, jm = j_optim.apply_updates(
                jp, jax.tree.map(jnp.asarray, grads), js, jcfg)
            tp, ts, tm = t_optim.apply_updates(tp, _t(grads), ts, tcfg)
            assert int(ts.step) == int(js.step) == step + 1
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=OPT_RTOL)
            for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
                jax.tree.map(lambda g, w: np.testing.assert_allclose(
                    g, np.asarray(w, np.float32), rtol=OPT_RTOL,
                    atol=1e-7), _np(got), jax.tree.map(np.asarray, want))

    def test_decay_on_matrices_only(self):
        """Zero gradients: the update is the decay alone, lr * wd * p on
        tensors of two or more dims; vectors and scalars stay put."""
        params = _t(_tree(np.random.default_rng(1)))
        cfg = t_optim.AdamWConfig(lr=0.1, weight_decay=0.5)
        zero = {k: (torch.zeros_like(v) if torch.is_tensor(v) else
                    {kk: torch.zeros_like(vv) for kk, vv in v.items()})
                for k, v in params.items()}
        new, _, m = t_optim.apply_updates(params, zero,
                                          t_optim.init_opt(params, cfg), cfg)
        assert float(m["grad_norm"]) == 0.0
        assert torch.equal(new["b"], params["b"])
        assert torch.equal(new["eps"], params["eps"])
        for got, p in ((new["w"], params["w"]),
                       (new["layers"]["m"], params["layers"]["m"])):
            torch.testing.assert_close(got, p * (1 - 0.1 * 0.5))

    def test_pure(self):
        params = _t(_tree(np.random.default_rng(2)))
        before = {k: v.clone() for k, v in params.items()
                  if torch.is_tensor(v)}
        cfg = t_optim.AdamWConfig()
        state = t_optim.init_opt(params, cfg)
        t_optim.apply_updates(params, _t(_tree(np.random.default_rng(3))),
                              state, cfg)
        assert all(torch.equal(params[k], v) for k, v in before.items())
        assert int(state.step) == 0

    @pytest.mark.parametrize("moments", ["float32", "bfloat16"])
    def test_opt_state_from_jax(self, moments):
        rng = np.random.default_rng(5)
        cfg = j_optim.AdamWConfig(moment_dtype=moments)
        jp = jax.tree.map(jnp.asarray, _tree(rng))
        _, js, _ = j_optim.apply_updates(
            jp, jax.tree.map(jnp.asarray, _tree(rng)),
            j_optim.init_opt(jp, cfg), cfg)
        ts = t_optim.opt_state_from_jax(
            jax.tree.map(np.asarray, js), device="cpu")
        assert ts.step.dtype == torch.int32 and int(ts.step) == 1
        for got, want in ((ts.m, js.m), (ts.v, js.v)):
            assert got["w"].dtype == getattr(torch, moments)
            jax.tree.map(lambda g, w: np.testing.assert_array_equal(
                g, np.asarray(w, np.float32)), _np(got),
                jax.tree.map(np.asarray, want))


class TestGradients:
    @pytest.mark.parametrize("kind", KINDS)
    def test_match_jax_grad(self, graph, batch, kind):
        b, labels = batch
        jcfg, tcfg = _cfgs(kind, graph)
        jp = j_init(jcfg, jax.random.PRNGKey(7))
        (jloss, jacc), jg = jax.value_and_grad(
            lambda p: _j_loss(jcfg, p, b, jnp.asarray(labels)),
            has_aux=True)(jp)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        loss, acc, tg = t_train.gnn_grads(tcfg, tp, tb,
                                          torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=METRIC_RTOL)
        assert abs(float(acc) - float(jacc)) <= 1.0 / C
        want = jax.tree.map(np.asarray, jg)

        def held(g, w):
            scale = float(np.abs(w).max())
            assert scale > 0                  # every leaf gets a gradient
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD_ATOL * scale)
        jax.tree.map(held, _np(tg), want)
        assert not any(p.requires_grad for p in t_optim.tree_leaves(tp))


class TestTrainStep:
    @pytest.mark.parametrize("kind", ["gcn", "gat"])
    def test_one_step_matches_reference(self, graph, batch, kind):
        b, labels = batch
        jcfg, tcfg = _cfgs(kind, graph)
        jp = j_init(jcfg, jax.random.PRNGKey(8))
        jopt = j_optim.AdamWConfig(lr=3e-3, weight_decay=0.0)
        topt = t_optim.AdamWConfig(lr=3e-3, weight_decay=0.0)
        _, _, jm = j_make_step(jcfg, jopt)(
            jp, j_optim.init_opt(jp, jopt), b, jnp.asarray(labels))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        step = t_train.make_gnn_train_step(tcfg, topt)
        new, state, tm = step(tp, t_optim.init_opt(tp, topt),
                              {k: torch.from_numpy(v) for k, v in b.items()},
                              torch.from_numpy(labels))
        assert sorted(tm) == sorted(jm) == ["acc", "grad_norm", "loss"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=METRIC_RTOL)
        assert abs(float(tm["acc"]) - float(jm["acc"])) <= 1.0 / C
        assert int(state.step) == 1
        moved = [not torch.equal(a, b_) for a, b_ in zip(
            t_optim.tree_leaves(new), t_optim.tree_leaves(tp))]
        assert any(moved)

    def test_refuses_other_impls(self, graph):
        _, tcfg = _cfgs("gcn", graph)
        with pytest.raises(ValueError, match="impl='torch'"):
            t_train.make_gnn_train_step(tcfg, t_optim.AdamWConfig(),
                                        impl="cuda")
        with pytest.raises(ValueError, match="num_classes"):
            t_train.make_gnn_train_step(
                GNNConfig(kind="gcn", num_classes=0), t_optim.AdamWConfig())

    def test_train_batch_is_the_reference_build(self, graph):
        targets = np.array([3, 17, 40, 41])
        _, tcfg = _cfgs("sage", graph)
        b, labels = t_train.train_batch(get_graph("flickr", scale=0.02,
                                                  seed=1), tcfg, targets,
                                        "cpu")
        sb = j_build_batch(graph, targets, N, num_threads=4)
        for k in t_train.BATCH_KEYS:
            assert np.array_equal(b[k].numpy(), getattr(sb, k)), k
        assert labels.dtype == torch.int64
        assert np.array_equal(labels.numpy(), graph.labels[targets])


class TestTrainGNN:
    @pytest.mark.parametrize("kind", ["gcn", "sage"])
    def test_loss_decreases(self, kind):
        """tests/test_system.py's case on the port."""
        graph = get_graph("flickr", scale=0.02, seed=1)
        cfg = GNNConfig(kind=kind, n_layers=2, receptive_field=32,
                        f_in=graph.feature_dim, num_classes=7)
        out = t_train.train_gnn(graph, cfg, steps=30, batch_size=16,
                                lr=3e-3, eval_every=0, device="cpu")
        first = np.mean([h["loss"] for h in out["history"][:5]])
        last = np.mean([h["loss"] for h in out["history"][-5:]])
        assert last < first
        assert len(out["build_s"]) == len(out["step_s"]) == 30
        assert sorted(out["history"][0]) == ["acc", "grad_norm", "loss"]


class TestKernelGuard:
    def test_refuses_inputs_that_require_grad(self):
        x = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            build.refuse_grad("fused_gnn_layer", None, torch.zeros(2), x)
        with torch.no_grad():
            build.refuse_grad("fused_gnn_layer", x)
        build.refuse_grad("fused_gnn_layer", x.detach(), None)

    def test_cpu_plain_path_keeps_autograd(self):
        """On the CPU a wrapper takes its plain version, which autograd
        differentiates."""
        from repro_torch.kernels.fused_gnn import fused_gnn_layer
        rng = np.random.default_rng(0)
        adj = torch.from_numpy(rng.random((1, 4, 4), np.float32))
        h = torch.from_numpy(rng.standard_normal((1, 4, 8), np.float32))
        w = torch.from_numpy(rng.standard_normal((8, 4), np.float32))
        w.requires_grad_(True)
        fused_gnn_layer(adj, h, w).sum().backward()
        assert w.grad is not None and float(w.grad.abs().sum()) > 0
