"""The dense-LM slice of the PyTorch package against the reference on the
CPU: the plain version of the ``flash_attention`` kernel against the
reference's Pallas kernel (interpret mode), the attention, norm, rope and
MLP blocks, and ``prefill`` / ``decode_step`` of every dense arch's
``reduced()`` config with the reference's weights carried across by
``params_from_jax``. Inputs come from numpy seeds and are handed to both.

Tolerances: the flash kernel's at the reference test's (fp32 2e-5, bf16
3e-2). Blocks and whole models are fp32 on both sides, summed in other
orders by XLA and PyTorch, so they are held to rtol 1e-4 with an absolute
term in units of the output's largest magnitude (at least 1): 1e-5 for
prefill, and 1e-3 for decode, whose KV cache and probabilities are cast
to bf16 (as in the reference): a probability whose fp32 value differs in
its last bit between the two sides can round to neighbouring bf16 values
(a step of 2^-8 relative), and one such element moved the reduced
chatglm3's decode logits by 1.2e-4 of their scale.

The serving configs compute in bf16 (fp32 parameters cast per layer), so
the reduced configs are also run with that policy, the norm scales moved
off 1 so that the final norm's output is not bf16-valued. Measured on the
CPU: the reference's jit and op-by-op runs of one model differ by
1.2-1.3e-2 of max |logit| (XLA fuses elementwise ops and rounds at other
points; its bf16 sigmoid is not the correctly rounded one torch's SiLU
gives), its bf16 and fp32 runs by 1.8-2.6e-2, and the port's prefill and
decode lie within 2.4e-2 of the jit'd reference: held at ``BF16_REL`` =
5e-2 of max |logit|. That cannot tell bf16 from fp32 compute, so a second
case swaps SwiGLU's SiLU for ReLU on both sides (ReLU rounds nowhere) and
compares with the reference run op by op, where both round at the same
points: 75-100 % of the prefill logits and all decode logits came out
bitwise equal (0 % with fp32 compute, 8 % through the flash kernel's
plain version, which keeps the probabilities in fp32); held at
``BF16_EQUAL`` = half of them bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.kernels import flash_attention as j_flash  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import mlp as j_mlp  # noqa: E402
from repro.models import rope as j_rope  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import mlp as t_mlp  # noqa: E402
from repro_torch.models import rope as t_rope  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.train import optim as t_optim  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402

DENSE = ("chatglm3-6b", "deepseek-7b", "qwen1.5-4b", "phi3-medium-14b")
RTOL = 1e-4
DECODE_ATOL = 1e-3
BF16_REL = 5e-2
BF16_EQUAL = 0.5


def _close(got, want, atol=1e-5, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestConfigs:
    @pytest.mark.parametrize("name", list(j_registry.ARCHS))
    def test_registry_is_a_copy(self, name):
        jc, tc = j_registry.get_config(name), t_registry.get_config(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(tc.reduced()) == \
            dataclasses.asdict(jc.reduced())
        assert dataclasses.asdict(t_base.optimized(tc)) == \
            dataclasses.asdict(j_base.optimized(jc))
        assert tc.resolved_head_dim == jc.resolved_head_dim


class TestFlashAttention:
    """The wrapper on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode, on the shapes of
    tests/test_kernels.py (causal with Sq != Sk included: both align the
    mask top-left)."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("b,h,sq,sk,d,bq,bk", [
        (1, 2, 64, 64, 32, 32, 32),
        (2, 1, 128, 128, 64, 64, 32),
        (1, 2, 64, 128, 32, 32, 64),
    ])
    def test_matches_reference_kernel(self, b, h, sq, sk, d, bq, bk,
                                      causal):
        rng = np.random.default_rng(sq + sk + d)
        q, k, v = (_normal(rng, (b, h, s, d)) for s in (sq, sk, sk))
        want = j_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=bq, block_k=bk, interpret=True)
        before = t_flash.launches
        got = t_flash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
        assert t_flash.launches == before          # no launch on the CPU
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)

    def test_bf16(self):
        rng = np.random.default_rng(0)
        q, k, v = (_normal(rng, (1, 2, 64, 32)) for _ in range(3))
        want = j_flash.flash_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            block_q=32, block_k=32, interpret=True)
        got = t_flash.flash_attention(
            *(_t(a).to(torch.bfloat16) for a in (q, k, v)))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)

    @pytest.mark.parametrize("sq,sk,d,causal", [
        (100, 100, 200, True), (77, 130, 64, False), (130, 77, 16, True)])
    def test_ragged_against_float64_softmax(self, sq, sk, d, causal):
        """Lengths no tile divides: the plain version against a float64
        softmax (the reference's wrapper refuses them)."""
        rng = np.random.default_rng(sq * sk)
        q, k, v = (_normal(rng, (1, 3, s, d)) for s in (sq, sk, sk))
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / d ** 0.5
        if causal:
            s = np.where(np.tril(np.ones((sq, sk), bool)), s, -1e30)
        p = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
        got = t_flash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

    def test_rejects_what_the_kernel_does_not_take(self):
        q = torch.zeros(1, 2, 8, 16)
        with pytest.raises(ValueError, match="do not match"):
            t_flash.flash_attention(q, torch.zeros(1, 3, 8, 16),
                                    torch.zeros(1, 3, 8, 16))
        with pytest.raises(TypeError, match="float32 or"):
            t_flash.flash_attention(q, q.double(), q)
        with pytest.raises(ValueError, match="empty"):
            t_flash.flash_attention(q, q[:, :, :0], q[:, :, :0])
        with pytest.raises(ValueError, match=r"\[B,H,S,D\]"):
            t_flash.flash_attention(q[0], q[0], q[0])

    @pytest.mark.parametrize("args", [(1, 40, 8192, 8192, 128, True, 2),
                                      (2, 4, 64, 128, 32, False, 4),
                                      (1, 2, 64, 64, 16, True, 4)])
    def test_flash_cost_is_the_reference_model(self, args):
        assert t_flash.flash_cost(*args) == j_flash.flash_cost(*args)


class TestBlocks:
    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    def test_rms_norm(self, x_dtype):
        rng = np.random.default_rng(1)
        x, s = _normal(rng, (2, 5, 64), 3.0), _normal(rng, (64,))
        want = j_common.rms_norm(jnp.asarray(x, x_dtype), jnp.asarray(s))
        got = t_common.rms_norm(_t(x).to(getattr(torch, x_dtype)), _t(s))
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-6)

    def test_layer_norm(self):
        rng = np.random.default_rng(2)
        x, s, b = (_normal(rng, sh) for sh in ((3, 64), (64,), (64,)))
        want = j_common.layer_norm(*(jnp.asarray(a) for a in (x, s, b)))
        got = t_common.layer_norm(_t(x), _t(s), _t(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
    def test_act_fn(self, name):
        x = np.linspace(-6, 6, 301, dtype=np.float32)
        np.testing.assert_allclose(
            t_common.act_fn(name)(_t(x)).numpy(),
            np.asarray(j_common.act_fn(name)(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
    def test_apply_rope(self, fraction):
        rng = np.random.default_rng(3)
        x = _normal(rng, (2, 9, 4, 16))
        pos = np.arange(3, 12)[None, :].astype(np.int32)
        want = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                 fraction)
        got = t_rope.apply_rope(_t(x), _t(pos), 1e4, fraction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_swiglu_mlp(self):
        rng = np.random.default_rng(4)
        x = _normal(rng, (2, 7, 64))
        p = {"w_gate": _normal(rng, (64, 128), 0.125),
             "w_up": _normal(rng, (64, 128), 0.125),
             "w_down": _normal(rng, (128, 64), 0.09)}
        want = j_mlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
        got = t_mlp.mlp({k: _t(v) for k, v in p.items()}, _t(x))
        _close(got, want)

    def test_cast_tree(self):
        tree = {"a": torch.zeros(2),
                "b": {"c": torch.zeros(2, dtype=torch.int32)}}
        out = t_common.cast_tree(tree, torch.bfloat16)
        assert out["a"].dtype == torch.bfloat16
        assert out["b"]["c"].dtype == torch.int32


def _attn_params(rng, n_heads, n_kv, dh=16, d=64, bias=False):
    p = {"wq": _normal(rng, (d, n_heads * dh), 0.125),
         "wk": _normal(rng, (d, n_kv * dh), 0.125),
         "wv": _normal(rng, (d, n_kv * dh), 0.125),
         "wo": _normal(rng, (n_heads * dh, d), 0.125)}
    if bias:
        for name, w in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = _normal(rng, (w * dh,), 0.1)
    return p


class TestAttention:
    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    @pytest.mark.parametrize("n_kv", [1, 2, 4])
    @pytest.mark.parametrize("fraction", [1.0, 0.5])
    def test_full_attention(self, impl, n_kv, fraction):
        """Query head h reads KV head h // G: n_kv = 1, 2 and 4 of 4
        heads; impl="cuda" is the kernel's path (its plain version on
        the CPU), including the KV broadcast around it."""
        rng = np.random.default_rng(10 * n_kv + int(fraction * 2))
        p = _attn_params(rng, 4, n_kv, bias=True)
        x = _normal(rng, (2, 24, 64))
        kw = dict(n_heads=4, n_kv=n_kv, head_dim=16, rope_fraction=fraction)
        want = j_attn.full_attention(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), **kw)
        got = t_attn.full_attention({k: _t(v) for k, v in p.items()},
                                    _t(x), impl=impl, **kw)
        _close(got, want)

    @pytest.mark.parametrize("n_kv", [1, 2, 4])
    def test_chunked_attention(self, n_kv):
        rng = np.random.default_rng(20 + n_kv)
        p = _attn_params(rng, 4, n_kv)
        x = _normal(rng, (1, 32, 64))
        kw = dict(n_heads=4, n_kv=n_kv, head_dim=16, rope_fraction=0.5,
                  chunk_q=8)
        want = j_attn.full_attention(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), **kw)
        got = t_attn.full_attention({k: _t(v) for k, v in p.items()},
                                    _t(x), impl="torch", **kw)
        _close(got, want)
        with pytest.raises(ValueError, match="multiple"):
            t_attn.chunked_gqa_attention(*(torch.zeros(1, 10, 4, 16)
                                           for _ in range(3)), block_q=4)

    @pytest.mark.parametrize("n_kv", [1, 2, 4])
    def test_decode_attention(self, n_kv):
        """Three steps into a bf16 cache (fp32 q against the bf16 cache,
        the probabilities cast to bf16 before P.V, as in the reference)."""
        rng = np.random.default_rng(30 + n_kv)
        p = _attn_params(rng, 4, n_kv)
        kw = dict(n_heads=4, n_kv=n_kv, head_dim=16, rope_fraction=0.5)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: _t(v) for k, v in p.items()}
        jk = jv = jnp.zeros((2, 8, n_kv, 16), jnp.bfloat16)
        tk = torch.zeros(2, 8, n_kv, 16, dtype=torch.bfloat16)
        tv = tk.clone()
        for pos in range(3):
            x = _normal(rng, (2, 1, 64))
            want, jk, jv = j_attn.decode_attention(jp, jnp.asarray(x), jk,
                                                   jv, pos, **kw)
            got, tk, tv = t_attn.decode_attention(tp, _t(x), tk, tv, pos,
                                                  **kw)
            _close(got, want, atol=DECODE_ATOL)
            assert np.array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
        with pytest.raises(ValueError, match="pos"):
            t_attn.decode_attention(tp, _t(x), tk, tv, 8, **kw)

    def test_bad_impl(self):
        with pytest.raises(ValueError, match="impl"):
            t_attn.full_attention({}, torch.zeros(1, 2, 64), n_heads=4,
                                  n_kv=4, head_dim=16, impl="pallas")


@pytest.fixture(scope="module", params=DENSE)
def lm(request):
    """One reduced dense arch run through the reference: its params (as
    numpy), prompt, prefill logits and three decode steps' logits."""
    name = request.param
    jc = j_registry.get_config(name, reduced=True)
    jp = j_tf.init_params(jc, jax.random.PRNGKey(3))
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 12)).astype(np.int32)
    logits = jax.jit(lambda p, t: j_tf.prefill(jc, p, {"tokens": t}))(
        jp, jnp.asarray(tokens))
    step = jax.jit(lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t, pos))
    cache, steps = j_tf.init_cache(jc, 2, 16), []
    for pos in range(3):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, pos:pos + 1]), pos)
        steps.append(np.asarray(lg))
    return dict(cfg=t_registry.get_config(name, reduced=True),
                params=jax.tree.map(np.asarray, jp), tokens=tokens,
                prefill=np.asarray(logits), steps=steps)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


class TestDenseModel:
    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_prefill_matches_reference(self, lm, impl):
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        got = t_tf.prefill(lm["cfg"], params, {"tokens": lm["tokens"]},
                           impl=impl)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == lm["prefill"].shape
        _close(got, lm["prefill"])

    def test_decode_matches_reference(self, lm):
        cfg = lm["cfg"]
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        cache = t_tf.init_cache(cfg, 2, 16, device="cpu")
        assert cache["attn"]["k"].dtype == torch.bfloat16
        for pos in range(3):
            got, cache = t_tf.decode_step(
                cfg, params, cache, lm["tokens"][:, pos:pos + 1], pos)
            _close(got, lm["steps"][pos], atol=DECODE_ATOL)

    def test_params_layout(self, lm):
        """params_from_jax keeps every leaf's shape (the stacked layer
        axis too) and type; init_params draws the same tree."""
        want = _shapes(lm["params"])
        assert _shapes(t_tf.params_from_jax(lm["params"],
                                            device="cpu")) == want
        drawn = t_tf.init_params(lm["cfg"], seed=0, device="cpu")
        assert _shapes(drawn) == want
        again = t_tf.init_params(lm["cfg"], seed=0, device="cpu")
        assert torch.equal(drawn["blocks"]["mixer"]["wq"],
                           again["blocks"]["mixer"]["wq"])
        fan_in = lm["cfg"].d_model
        std = float(drawn["blocks"]["ffn"]["w_gate"].std())
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5

    def test_bf16_leaves_stay_bf16(self):
        tree = {"w": np.asarray(jnp.asarray([[1.5, -2.25]], jnp.bfloat16)),
                "s": np.ones((2, 3), np.float32)}
        out = t_tf.params_from_jax(tree, device="cpu")
        assert out["w"].dtype == torch.bfloat16
        assert out["w"].float().tolist() == [[1.5, -2.25]]
        assert out["s"].dtype == torch.float32 and out["s"].shape == (2, 3)


def _bf16_compute(cfg, base):
    return dataclasses.replace(cfg, dtype=base.DTypePolicy(
        param_dtype="float32", compute_dtype="bfloat16"))


def _bf16_lm(name):
    """A reduced dense arch with bf16 compute: the reference's config and
    params (norm scales drawn around 1), the port's config, a prompt."""
    jc = _bf16_compute(j_registry.get_config(name, reduced=True), j_base)
    jp = j_tf.init_params(jc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(7)
    jp["final_norm"] = jnp.asarray(
        1 + _normal(rng, jp["final_norm"].shape, 0.1))
    for k in ("ln1", "ln2"):
        jp["blocks"][k] = jnp.asarray(
            1 + _normal(rng, jp["blocks"][k].shape, 0.1))
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 12)).astype(np.int32)
    return dict(jcfg=jc, jparams=jp, tokens=tokens,
                cfg=_bf16_compute(t_registry.get_config(name, reduced=True),
                                  t_base),
                params=t_tf.params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu"))


def _reference_run(jc, jp, tokens, jit=True):
    """The reference's prefill logits and three decode steps' logits,
    jit'd or (``jit=False``) op by op."""
    prefill = lambda p, t: j_tf.prefill(jc, p, {"tokens": t})  # noqa: E731
    step = lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t, pos)  # noqa
    if jit:
        prefill, step = jax.jit(prefill), jax.jit(step)
    with jax.disable_jit(not jit):
        logits = np.asarray(prefill(jp, jnp.asarray(tokens)))
        cache, steps = j_tf.init_cache(jc, 2, 16), []
        for pos in range(3):
            lg, cache = step(jp, cache, jnp.asarray(tokens[:, pos:pos + 1]),
                             pos)
            steps.append(np.asarray(lg))
    return logits, steps


def _port_decode(m):
    cache, steps = t_tf.init_cache(m["cfg"], 2, 16, device="cpu"), []
    for pos in range(3):
        lg, cache = t_tf.decode_step(m["cfg"], m["params"], cache,
                                     m["tokens"][:, pos:pos + 1], pos)
        steps.append(lg.numpy())
    return steps


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=DENSE)
def lm_bf16(request):
    m = _bf16_lm(request.param)
    m["prefill"], m["steps"] = _reference_run(m["jcfg"], m["jparams"],
                                              m["tokens"])
    return m


class TestBf16Compute:
    """The serving dtype policy (fp32 parameters, bf16 compute)."""

    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_prefill_matches_reference(self, lm_bf16, impl):
        got = t_tf.prefill(lm_bf16["cfg"], lm_bf16["params"],
                           {"tokens": lm_bf16["tokens"]}, impl=impl)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), lm_bf16["prefill"]) <= BF16_REL

    def test_decode_matches_reference(self, lm_bf16):
        for got, want in zip(_port_decode(lm_bf16), lm_bf16["steps"]):
            assert _rel(got, want) <= BF16_REL

    @pytest.mark.parametrize("name", DENSE)
    def test_rounds_where_the_reference_does(self, name, monkeypatch):
        """SiLU swapped for ReLU on both sides, the reference run op by op:
        the port's plain path rounds to bf16 at the same points."""
        monkeypatch.setattr(j_mlp, "act_fn", lambda _: jax.nn.relu)
        monkeypatch.setattr(t_mlp, "act_fn", lambda _: torch.relu)
        m = _bf16_lm(name)
        logits, steps = _reference_run(m["jcfg"], m["jparams"], m["tokens"],
                                       jit=False)
        got = t_tf.prefill(m["cfg"], m["params"], {"tokens": m["tokens"]},
                           impl="torch").numpy()
        assert float((got == logits).mean()) >= BF16_EQUAL
        assert _rel(got, logits) <= BF16_REL
        for g, want in zip(_port_decode(m), steps):
            assert float((g == want).mean()) >= BF16_EQUAL

    def test_unembed_keeps_the_fp32_hidden_state(self):
        """The reference promotes the final norm's fp32 output against the
        bf16 head; rounding it to bf16 first moved these logits by 6e-3."""
        rng = np.random.default_rng(0)
        h, w = _normal(rng, (2, 5, 64)), _normal(rng, (64, 256), 0.125)
        jc = _bf16_compute(j_registry.get_config("phi3-medium-14b",
                                                 reduced=True), j_base)
        tc = _bf16_compute(t_registry.get_config("phi3-medium-14b",
                                                 reduced=True), t_base)
        want = j_tf._unembed(jc, {"lm_head": jnp.asarray(w)}, jnp.asarray(h))
        got = t_tf._unembed(tc, {"lm_head": _t(w)}, _t(h))
        _close(got, want)


def _spec_shapes(tree):
    """{path: (shape, dtype name)} of a JAX tree of arrays or
    ShapeDtypeStructs, or of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: _spec_shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


class TestEveryArch:
    """Every arch of the registry serves and trains in the port:
    init_params, prefill, init_cache and decode_step of its reduced config
    on the CPU, each with the reference's tree layout or output shape,
    every output finite; and one ``make_train_step`` step."""

    @pytest.mark.parametrize("name", list(t_registry.ARCHS))
    def test_serves_with_the_reference_shapes(self, name):
        jc = j_registry.get_config(name, reduced=True)
        cfg = t_registry.get_config(name, reduced=True)
        B, S = 2, 16
        params = t_tf.init_params(cfg, seed=0, device="cpu", max_seq=S)
        want = jax.eval_shape(lambda: j_tf.init_params(
            jc, jax.random.PRNGKey(0), max_seq=S))
        assert _spec_shapes(params) == _spec_shapes(want)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
        if cfg.encoder is not None:
            batch["frames"] = _normal(
                rng, (B, cfg.encoder.n_frames, cfg.d_model))
        if cfg.vision is not None:
            batch["patch_embeds"] = _normal(
                rng, (B, cfg.vision.n_patches, cfg.d_model))
        for impl in ("cuda", "torch"):
            logits = t_tf.prefill(cfg, params, batch, impl=impl)
            assert tuple(logits.shape) == (B, S, cfg.vocab_size)
            assert bool(torch.isfinite(logits).all())
        cache = t_tf.init_cache(cfg, B, S, device="cpu")
        assert _spec_shapes(cache) == _spec_shapes(
            j_tf.init_cache(jc, B, S, mode="specs"))
        for pos in range(2):
            logits, cache = t_tf.decode_step(
                cfg, params, cache, batch["tokens"][:, pos:pos + 1], pos)
            assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
            assert bool(torch.isfinite(logits).all())

    @pytest.mark.parametrize("name", list(t_registry.ARCHS))
    def test_takes_a_train_step(self, name):
        cfg = t_registry.get_config(name, reduced=True)
        B, S = 2, 16
        params = t_tf.init_params(cfg, seed=0, device="cpu", max_seq=S)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S))}
        if cfg.encoder is not None:
            batch["frames"] = _normal(
                rng, (B, cfg.encoder.n_frames, cfg.d_model))
        if cfg.vision is not None:
            batch["patch_embeds"] = _normal(
                rng, (B, cfg.vision.n_patches, cfg.d_model))
        opt_cfg = t_optim.AdamWConfig(lr=1e-3)
        new, state, metrics = t_step.make_train_step(cfg, opt_cfg)(
            params, t_optim.init_opt(params, opt_cfg), batch)
        assert {"loss", "xent", "aux", "grad_norm"} <= set(metrics)
        assert all(bool(torch.isfinite(metrics[k]))
                   for k in ("loss", "xent", "aux", "grad_norm"))
        assert float(metrics["grad_norm"]) > 0 and int(state.step) == 1
        assert _spec_shapes(new) == _spec_shapes(params)
        assert any(not torch.equal(a, b) for a, b in zip(
            t_optim.tree_leaves(new), t_optim.tree_leaves(params)))


class TestNotPorted:
    """Nothing is left unported; what the port refuses is a card that is
    not there."""

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the no-card path does "
                        "not apply")
        cfg = t_registry.get_config("phi3-medium-14b", reduced=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_tf.init_params(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_tf.init_cache(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_tf.params_from_jax({"w": np.zeros(2, np.float32)})
