"""LM training in the PyTorch package against the reference on the CPU:
``softmax_xent``, ``train_logits`` and the gradients of ``loss_fn`` for
every arch of the registry against ``jax.value_and_grad``, the MoE gather
dispatch's autograd pair against the reference's ``custom_vjp`` pair (and
against autograd through plain indexing, in float64), remat against no
remat, three ``make_train_step`` steps against the reference's, the token
pipeline bitwise, gradient compression bitwise over three feedback steps,
checkpoints of (params, OptState) read by both packages, kill-and-resume
through ``train.loop.train`` on the CPU, and ``launch/train.py`` in a
subprocess. The reference's weights are carried across by
``params_from_jax``; inputs come from numpy seeds and are handed to both.

The port's ``softmax_xent`` takes the max out of the graph; the
reference's ``stop_gradient`` covers the shifted exponentials only, so its
gradient carries an extra one-hot at each row's max (ROADMAP.md section 3;
``TestXent`` shows both). Gradients and train steps are held against the
reference with that one line repaired (``repaired_xent``: the reference's
formula, its values bit for bit, the max under ``stop_gradient``).

Tolerances. Everything is fp32 on both sides (the reduced configs), summed
in other orders by XLA and PyTorch: logits at rtol 1e-4 with an absolute
term of 1e-5 of their largest magnitude (tests/test_torch_lm.py's);
each gradient leaf at ``GRAD_TOL`` = 1e-4 of the leaf's largest |g| (the
largest distance measured was 1.9e-5, Jamba's); losses at rtol 1e-5. After
AdamW steps a parameter moves by about lr times the sign of its gradient's
moments wherever the gradient is not tiny, so the parameters are held at
``STEP_TOL`` = 1e-4 of each leaf's largest magnitude, with at most
``STEP_FLIPS`` = 1e-3 of a leaf's elements beyond it (an element whose
gradient lies within rounding of 0 may take the other sign). So the
second and third steps' losses and grad norms are held at rtol 1e-4 (the
first at 1e-5): from parameters that differ in those elements, a MoE
token may also route to another expert, and the reduced deepseek's second
grad norm differed by 3.1e-5.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.distributed import compression as j_comp  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro.train import optim as j_optim  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro.train import xent as j_xent  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.distributed import compression as t_comp  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.train import loop as t_loop  # noqa: E402
from repro_torch.train import optim as t_optim  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402
from repro_torch.train import xent as t_xent  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(t_registry.ARCHS)
GRAD_TOL, STEP_TOL, STEP_FLIPS = 1e-4, 1e-4, 1e-3
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=1e-5, rtol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _within(seconds, fn):
    """``fn()`` on a thread of its own, failing if it has not returned
    within ``seconds`` (a pipeline test must not hang the suite)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:          # noqa: BLE001
            out["error"] = e
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _pair(name, **moe):
    """(reference config, its params, port config, the port's copy)."""
    jc = j_registry.get_config(name, reduced=True)
    tc = t_registry.get_config(name, reduced=True)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    jp = j_tf.init_params(jc, jax.random.PRNGKey(3), max_seq=S)
    return jc, jp, tc, t_tf.params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu")


def _xent_max_out_of_graph(logits, labels, mask=None):
    """The reference's ``softmax_xent`` with its ``stop_gradient`` over the
    max itself: the same values, the gradient softmax - onehot(label)."""
    lg = logits.astype(jnp.float32)
    m = jax.lax.stop_gradient(jnp.max(lg, axis=-1, keepdims=True))
    lse = jnp.log(jnp.sum(jnp.exp(lg - m), axis=-1)) + m[..., 0]
    per_tok = lse - jnp.take_along_axis(lg, labels[..., None],
                                        axis=-1)[..., 0]
    if mask is None:
        mask = jnp.ones_like(per_tok)
    mask = mask.astype(jnp.float32)
    return (jnp.sum(per_tok * mask) / jnp.maximum(jnp.sum(mask), 1.0),
            per_tok)


@pytest.fixture
def repaired_xent(monkeypatch):
    """The reference's loss_fn and train step with the repaired xent."""
    monkeypatch.setattr(j_step, "softmax_xent", _xent_max_out_of_graph)


def _leaf_close(got, want, tol=GRAD_TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale + 1e-30


class TestXent:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_reference(self, masked):
        """The per-token loss bitwise the reference's, the mean at rtol
        1e-6 (the masked sum adds in another order); the gradient the
        repaired formula's."""
        rng = np.random.default_rng(0)
        logits = rng.standard_normal((2, 5, 17)).astype(np.float32)
        labels = rng.integers(0, 17, (2, 5)).astype(np.int32)
        mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked \
            else None
        jm = None if mask is None else jnp.asarray(mask)
        jl, jper = j_xent.softmax_xent(jnp.asarray(logits),
                                       jnp.asarray(labels), jm)
        jg = jax.grad(lambda x: _xent_max_out_of_graph(
            x, jnp.asarray(labels), jm)[0])(jnp.asarray(logits))
        x = _t(logits).requires_grad_(True)
        tl, tper = t_xent.softmax_xent(x, labels, mask)
        (tg,) = torch.autograd.grad(tl, x)
        _close(tl, jl, atol=0.0, rtol=1e-6)
        np.testing.assert_array_equal(tper.detach().numpy(),
                                      np.asarray(jper))
        _close(tg, jg)

    def test_all_masked_divides_by_one(self):
        got, _ = t_xent.softmax_xent(torch.zeros(1, 3, 8),
                                     torch.zeros(1, 3, dtype=torch.int64),
                                     torch.zeros(1, 3))
        assert float(got) == 0.0

    def test_gradient_is_softmax_minus_onehot(self):
        """The port's gradient is (softmax - onehot(label)) / N; the
        reference's adds onehot(argmax) / N (its stop_gradient misses the
        ``+ m`` term)."""
        rng = np.random.default_rng(1)
        logits = rng.standard_normal((1, 4, 9)).astype(np.float32)
        labels = rng.integers(0, 9, (1, 4)).astype(np.int32)
        x = _t(logits).requires_grad_(True)
        (g,) = torch.autograd.grad(t_xent.softmax_xent(x, labels)[0], x)
        lg = _t(logits)
        onehot = torch.nn.functional.one_hot
        want = (torch.softmax(lg, -1) - onehot(_t(labels).long(), 9)) / 4
        torch.testing.assert_close(g, want.float(), rtol=1e-5, atol=1e-6)
        jg = jax.grad(lambda v: j_xent.softmax_xent(
            v, jnp.asarray(labels))[0])(jnp.asarray(logits))
        extra = onehot(lg.argmax(-1), 9).float() / 4
        torch.testing.assert_close(_t(np.array(jg)), want + extra,
                                   rtol=1e-5, atol=1e-6)


class TestEveryArchTrains:
    @pytest.mark.parametrize("name", ARCHS)
    def test_train_logits_and_grads(self, name, repaired_xent):
        """train_logits (with deepseek-v3's MTP logits) and loss_fn's value
        and every gradient leaf against jax.value_and_grad (the reference's
        loss with its xent repaired)."""
        jc, jp, tc, tp = _pair(name)
        batch = _batch(tc)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jlg, jex = jax.jit(lambda p, b: j_tf.train_logits(jc, p, b))(jp, jb)
        with torch.no_grad():
            tlg, tex = t_tf.train_logits(tc, tp, batch)
        _close(tlg, jlg)
        assert sorted(tex) == sorted(jex)
        if "mtp_logits" in jex:
            _close(tex["mtp_logits"], jex["mtp_logits"])
        _close(tex["aux_loss"], jex["aux_loss"])
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: j_step.loss_fn(jc, p, jb), has_aux=True))(jp)
        tl, tm, tg = t_step.grads_of(tc, tp, batch)
        _close(tl, jl, rtol=1e-5)
        _close(tm["xent"], jm["xent"], rtol=1e-5)
        flat_j = jax.tree.leaves(jg)
        flat_t = t_optim.tree_leaves(tg)
        assert len(flat_t) == len(flat_j)
        for got, want in zip(flat_t, flat_j):
            assert tuple(got.shape) == want.shape
            _leaf_close(got, want)

    @pytest.mark.parametrize("name", ["whisper-tiny", "pixtral-12b",
                                      "deepseek-v2-lite-16b",
                                      "jamba-1.5-large-398b"])
    def test_remat_equals_no_remat(self, name):
        """Gradients under torch.utils.checkpoint bitwise equal to those
        without (the MoE family with the gather dispatch's pair)."""
        moe = {"dispatch": "gather"} if name.startswith("deepseek") else {}
        _, _, tc, tp = _pair(name, **moe)
        batch = _batch(tc, seed=2)
        la, _, ga = t_step.grads_of(tc, tp, batch, remat=True)
        lb, _, gb = t_step.grads_of(tc, tp, batch, remat=False)
        assert torch.equal(la, lb)
        for a, b in zip(t_optim.tree_leaves(ga), t_optim.tree_leaves(gb)):
            assert torch.equal(a, b)

    def test_a_train_step_refuses_the_kernel_impl(self):
        cfg = t_registry.get_config("whisper-tiny", reduced=True)
        with pytest.raises(ValueError, match="plain path"):
            t_step.make_train_step(cfg, t_optim.AdamWConfig(), impl="cuda")


class TestMoEDispatchPair:
    def _moe_inputs(self):
        jc, jp, tc, tp = _pair("deepseek-v2-lite-16b", dispatch="gather")
        bp = {k: v[0] for k, v in jp["blocks"]["ffn"].items()
              if k != "shared"}
        bp["shared"] = {k: v[0] for k, v in
                        jp["blocks"]["ffn"]["shared"].items()}
        rng = np.random.default_rng(6)
        x = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
        g = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
        return jc, tc, bp, x, g

    def test_gradient_against_the_custom_vjp(self):
        """d(sum(y * g))/dx and /dparams through the pair against JAX's
        custom_vjp pair, with capacity drops (a capacity factor that drops
        some assignments) and without."""
        jc, tc, bp, x, g = self._moe_inputs()
        for cf in (1.25, 0.5):
            jmoe = dataclasses.replace(jc.moe, capacity_factor=cf)
            tmoe = dataclasses.replace(tc.moe, capacity_factor=cf)

            def jloss(p, xx):
                y, aux = j_moe.moe_ffn_gather(p, xx, jmoe)
                return jnp.sum(y * jnp.asarray(g)) + aux
            jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
                bp, jnp.asarray(x))
            tp = t_tf.params_from_jax(jax.tree.map(np.asarray, bp),
                                      device="cpu")
            tp = t_optim.tree_map(lambda p: p.requires_grad_(True), tp)
            xx = _t(x).requires_grad_(True)
            y, aux = t_moe.moe_ffn_gather(tp, xx, tmoe)
            loss = (y * _t(g)).sum() + aux
            flat = t_optim.tree_leaves(tp)
            grads = torch.autograd.grad(loss, [xx] + flat)
            _leaf_close(grads[0], jgx)
            for got, want in zip(grads[1:], jax.tree.leaves(jgp)):
                _leaf_close(got, want)

    def test_float64_against_plain_indexing(self, monkeypatch):
        """In float64 the pair's input gradient equals autograd through
        the plain indexing of the same forward (to 1e-12 of its largest
        element), and neither the forward nor that gradient moves when
        the layer runs under checkpoint."""
        _, tc, bp, x, g = self._moe_inputs()
        moe = dataclasses.replace(tc.moe, capacity_factor=0.5)
        tp = t_optim.tree_map(lambda p: p.double(), t_tf.params_from_jax(
            jax.tree.map(np.asarray, bp), device="cpu"))

        def grad_x(ckpt=False):
            xx = _t(x).double().requires_grad_(True)
            fn = lambda v: t_moe.moe_ffn_gather(tp, v, moe)[0]  # noqa
            y = (torch.utils.checkpoint.checkpoint(fn, xx,
                                                   use_reentrant=False)
                 if ckpt else fn(xx))
            (gx,) = torch.autograd.grad((y * _t(g).double()).sum(), xx)
            return y.detach(), gx

        y_pair, g_pair = grad_x()
        y_ck, g_ck = grad_x(ckpt=True)
        assert torch.equal(y_ck, y_pair) and torch.equal(g_ck, g_pair)
        monkeypatch.setattr(t_moe, "routed_dispatch",
                            lambda x2d, st, dt, k: t_moe._dispatch_gather(
                                x2d, st))
        monkeypatch.setattr(t_moe, "routed_combine",
                            lambda f, dt, sp: t_moe._combine_gather(f, dt))
        y_plain, g_plain = grad_x()
        assert torch.equal(y_plain, y_pair)
        err = float((g_pair - g_plain).abs().max())
        assert err <= 1e-12 * float(g_plain.abs().max())


class TestTrainStep:
    @pytest.mark.parametrize("name", ["whisper-tiny",
                                      "deepseek-v2-lite-16b"])
    def test_three_steps_against_the_reference(self, name, repaired_xent):
        jc, jp, tc, tp = _pair(name)
        jopt = j_optim.AdamWConfig(lr=1e-3)
        topt = t_optim.AdamWConfig(lr=1e-3)
        jstate = j_optim.init_opt(jp, jopt)
        tstate = t_optim.opt_state_from_jax(
            jax.tree.map(np.asarray, jstate), device="cpu")
        jstep = jax.jit(j_step.make_train_step(jc, jopt))
        tstep = t_step.make_train_step(tc, topt)
        for s in range(3):
            batch = _batch(tc, seed=10 + s)
            jp, jstate, jm = jstep(jp, jstate,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            tp, tstate, tm = tstep(tp, tstate, batch)
            assert sorted(tm) == sorted(jm)
            for k in ("loss", "xent", "grad_norm"):
                _close(tm[k], jm[k], rtol=1e-5 if s == 0 else 1e-4)
        assert int(tstate.step) == int(jstate.step) == 3
        for got, want in zip(t_optim.tree_leaves(tp), jax.tree.leaves(jp)):
            got, want = got.numpy(), np.asarray(want)
            off = np.abs(got - want) > STEP_TOL * np.abs(want).max()
            assert off.mean() <= STEP_FLIPS


class TestPipeline:
    @pytest.mark.parametrize("step", [0, 1, 7])
    def test_synthetic_batch_bitwise(self, step):
        kw = dict(vocab_size=51865, seq_len=64, global_batch=3, seed=5)
        got = t_pipe.synthetic_batch(t_pipe.TokenPipelineConfig(**kw), step)
        want = j_pipe.synthetic_batch(j_pipe.TokenPipelineConfig(**kw), step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])

    def test_prefetch_order_and_close(self):
        it = t_pipe.PrefetchIterator(lambda s: s, prefetch=2)
        got = _within(10, lambda: [next(it) for _ in range(5)])
        _within(10, it.close)
        assert got == [0, 1, 2, 3, 4]
        assert not it._thread.is_alive()

    def test_straggler_skip(self):
        calls = {"n": 0}

        def slow_produce(step):
            if calls["n"] == 0 and step == 1:
                calls["n"] += 1
                time.sleep(0.8)          # one slow worker batch
            return step

        it = t_pipe.PrefetchIterator(slow_produce, prefetch=1,
                                     straggler_timeout_s=0.15)
        got = _within(10, lambda: [next(it) for _ in range(4)])
        _within(10, it.close)
        assert got == [0, 1, 2, 3]
        assert it.stragglers_skipped >= 1

    def test_token_pipeline_and_vertex_stream(self):
        cfg = t_pipe.TokenPipelineConfig(vocab_size=64, seq_len=16,
                                         global_batch=2, seed=3)
        it = t_pipe.token_pipeline(cfg)
        got = _within(10, lambda: [next(it) for _ in range(3)])
        _within(10, it.close)
        for s, b in enumerate(got):
            np.testing.assert_array_equal(
                b["tokens"], j_pipe.synthetic_batch(
                    j_pipe.TokenPipelineConfig(vocab_size=64, seq_len=16,
                                               global_batch=2, seed=3),
                    s)["tokens"])
        a, b = (t_pipe.target_vertex_stream(1000, 8, seed=2),
                j_pipe.target_vertex_stream(1000, 8, seed=2))
        for _ in range(3):
            np.testing.assert_array_equal(next(a), next(b))

    def test_stub_inputs_are_the_references(self):
        """The trainer's per-step frames and patch embeddings: the
        reference loop's draws from np.random.default_rng(step)."""
        for name, key, width in (("whisper-tiny", "frames", "n_frames"),
                                 ("pixtral-12b", "patch_embeds",
                                  "n_patches")):
            cfg = t_registry.get_config(name, reduced=True)
            got = t_loop.stub_inputs(cfg, {}, 4, 2)[key]
            sub = cfg.encoder if key == "frames" else cfg.vision
            want = np.random.default_rng(4).standard_normal(
                (2, getattr(sub, width), cfg.d_model)).astype(np.float32)
            np.testing.assert_array_equal(got, want)
        assert "rng = np.random.default_rng(s)" in Path(
            j_loop.__file__).read_text()


class TestCompression:
    def test_three_feedback_steps_bitwise(self):
        rng = np.random.default_rng(1)
        shapes = {"w": (64, 32), "b": (32,), "z": (8,)}
        jres = j_comp.init_residual({k: jnp.zeros(s)
                                     for k, s in shapes.items()})
        tres = t_comp.init_residual({k: torch.zeros(s)
                                     for k, s in shapes.items()})
        for _ in range(3):
            g = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
            g["z"] = np.zeros(shapes["z"], np.float32)   # scale 1
            jq, jres = j_comp.compress_with_feedback(
                {k: jnp.asarray(v) for k, v in g.items()}, jres)
            tq, tres = t_comp.compress_with_feedback(
                {k: _t(v) for k, v in g.items()}, tres)
            for k in shapes:
                (q, s), (wq, ws) = tq[k], jq[k]
                assert q.dtype == torch.int8
                np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
                assert float(s) == float(ws)
                np.testing.assert_array_equal(tres[k].numpy(),
                                              np.asarray(jres[k]))
                np.testing.assert_array_equal(
                    t_comp.dequantize(q, s).numpy(),
                    np.asarray(j_comp.dequantize(wq, ws)))

    def test_wire_bytes_and_one_process_psum(self):
        p = {"w": torch.zeros(1024), "b": {"c": torch.zeros(3, 4)}}
        jp = {"w": jnp.zeros(1024), "b": {"c": jnp.zeros((3, 4))}}
        assert t_comp.compression_wire_bytes(p) == \
            j_comp.compression_wire_bytes(jp)
        q = t_comp.quantize(torch.linspace(-2, 2, 9))
        out = t_comp.psum_quantized({"w": q})["w"]
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, t_comp.dequantize(*q).to(torch.bfloat16))

    def test_psum_over_two_processes(self, tmp_path):
        """Two gloo processes: each gets the bf16 sum of both replicas'
        dequantized contributions."""
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        code = (
            "import sys, torch, torch.distributed as dist\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.distributed import compression as c\n"
            "rank = int(sys.argv[1])\n"
            f"dist.init_process_group('gloo', init_method="
            f"'tcp://127.0.0.1:{port}', world_size=2, rank=rank)\n"
            "x = torch.randn(16, generator=torch.Generator()"
            ".manual_seed(rank))\n"
            "out = c.psum_quantized({'w': c.quantize(x)})['w']\n"
            "print(out.float().tolist())\n"
            "dist.destroy_process_group()\n")
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                                  stdout=subprocess.PIPE, text=True,
                                  cwd=str(tmp_path)) for r in range(2)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0]
        want = sum(t_comp.dequantize(*t_comp.quantize(torch.randn(
            16, generator=torch.Generator().manual_seed(r)))).to(
                torch.bfloat16) for r in range(2))
        for out in outs:
            assert json.loads(out.strip().splitlines()[-1]) == \
                want.float().tolist()


class TestCheckpoints:
    def test_train_state_read_by_both_packages(self, tmp_path):
        """(params, OptState) saved by the port restores in the reference
        and back, key paths included ("1/.step", "1/.m/...")."""
        _, jp, _, tp = _pair("whisper-tiny")
        opt = t_optim.AdamWConfig()
        tstate = t_optim.init_opt(tp, opt)
        tstate = tstate._replace(step=torch.tensor(7, dtype=torch.int32))
        t_ckpt.save(str(tmp_path / "port"), 7, (tp, tstate))
        jstate = j_optim.init_opt(jp, j_optim.AdamWConfig())
        (jgot, jst), step, _ = j_ckpt.restore(str(tmp_path / "port"),
                                              (jp, jstate))
        assert step == 7 and int(jst.step) == 7
        for a, b in zip(jax.tree.leaves(jgot), t_optim.tree_leaves(tp)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        j_ckpt.save(str(tmp_path / "ref"), 3, (jp, jstate))
        (tgot, tst), step, _ = t_ckpt.restore(str(tmp_path / "ref"),
                                              (tp, tstate))
        assert step == 3 and isinstance(tst, t_optim.OptState)
        assert int(tst.step) == 0
        back, _, _ = t_ckpt.restore(str(tmp_path / "port"), (tp, tstate))
        assert int(back[1].step) == 7


class TestLoop:
    def test_failure_injection_and_resume(self, tmp_path):
        """tests/test_substrate.py's kill-and-resume on the port, on the
        CPU: the resumed losses equal the uninterrupted run's."""
        cfg = t_registry.get_config("whisper-tiny", reduced=True)
        kw = dict(steps=6, ckpt_every=2, seq_len=16, global_batch=2)
        _, _, full = t_loop.train(cfg, t_loop.TrainJobConfig(
            ckpt_dir=str(tmp_path / "ref"), **kw), device="cpu")
        job = t_loop.TrainJobConfig(ckpt_dir=str(tmp_path / "ck"),
                                    log_path=str(tmp_path / "log.jsonl"),
                                    **kw)
        with pytest.raises(RuntimeError, match="injected failure"):
            t_loop.train(cfg, job, fail_at_step=4, device="cpu")
        assert t_ckpt.committed_steps(job.ckpt_dir) == [2, 4]
        _, _, resumed = t_loop.train(cfg, job, device="cpu")
        assert resumed[0]["step"] == 5
        ref = {h["step"]: h["loss"] for h in full}
        for h in resumed:
            np.testing.assert_allclose(h["loss"], ref[h["step"]], rtol=1e-4)
        log = [json.loads(line) for line in
               (tmp_path / "log.jsonl").read_text().splitlines()]
        assert [r["step"] for r in log] == [1, 2, 3, 4, 5, 6]
        assert all(np.isfinite(r["loss"]) for r in log)

    def test_defaults_to_the_card(self):
        import inspect
        assert inspect.signature(t_loop.train).parameters[
            "device"].default == "cuda"
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the no-card path does "
                        "not apply")
        cfg = t_registry.get_config("whisper-tiny", reduced=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_loop.train(cfg, t_loop.TrainJobConfig(steps=1))

    def test_launcher_in_a_subprocess(self, tmp_path):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen1.5-4b", "--reduced", "--steps", "3", "--seq-len", "16",
             "--global-batch", "2", "--ckpt-dir", str(tmp_path / "ck"),
             "--ckpt-every", "2", "--log", str(tmp_path / "log.jsonl"),
             "--device", "cpu"], capture_output=True, text=True,
            timeout=300, env=env, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        summary = json.loads(out.stdout[out.stdout.index("{"):])
        assert summary["steps"] == 3
        assert np.isfinite(summary["first_loss"])
        assert t_ckpt.committed_steps(str(tmp_path / "ck")) == [2, 3]
