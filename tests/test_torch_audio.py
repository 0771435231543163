"""The audio family (whisper-tiny) of the PyTorch package against the
reference on the CPU: the plain GELU MLP, ``cross_kv`` and
``cross_attention``, the encoder (``_encode``), prefill on both impls,
``init_cache``'s tree, and decode steps over a filled cross cache against
the reference's ``decode_step`` on the same cache, with the reference's
weights carried across by ``params_from_jax``. Inputs come from numpy
seeds and are handed to both.

Tolerances, as tests/test_torch_lm.py's: fp32 on both sides, summed in
other orders, rtol 1e-4 with an absolute term in units of the output's
largest magnitude (at least 1): 1e-5 for blocks and prefill, 1e-3 for
decode (the KV caches and the probabilities over them are bf16, as in the
reference). The serving policy's bf16 compute is held at ``BF16_REL`` =
5e-2 of max |logit| (test_torch_lm.py's reason: XLA and torch round at
other points in bf16). Decode against prefill of the same tokens is held
at ``DECODE_REL`` = 1e-2 of max |logit|: decode reads the cross keys and
values from the bf16 cache where prefill keeps them in the compute type,
and the reference's own decode lies 4.4e-3 of max |logit| from its
prefill on this model (the port's 5.3e-3).
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
from repro.models import attention as j_attn  # noqa: E402
from repro.models import mlp as j_mlp  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import mlp as t_mlp  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

ARCH = "whisper-tiny"
RTOL, ATOL, DECODE_ATOL, BF16_REL = 1e-4, 1e-5, 1e-3, 5e-2
DECODE_REL = 1e-2
B, S, MAX_SEQ, STEPS = 2, 12, 16, 4


def _close(got, want, atol=ATOL, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(cfg, base):
    return dataclasses.replace(cfg, dtype=base.DTypePolicy(
        param_dtype="float32", compute_dtype="bfloat16"))


def _model(bf16=False):
    """The reduced whisper through both packages: configs, the reference's
    params (norm scales and biases drawn off 1 and 0, so the layer norms'
    affine terms count) and the port's copy, a prompt and frames."""
    jc = j_registry.get_config(ARCH, reduced=True)
    tc = t_registry.get_config(ARCH, reduced=True)
    if bf16:
        jc, tc = _bf16(jc, j_base), _bf16(tc, t_base)
    jp = j_tf.init_params(jc, jax.random.PRNGKey(3), max_seq=MAX_SEQ)
    rng = np.random.default_rng(11)
    for tree in (jp, jp["blocks"], jp["enc_blocks"]):
        for k in [k for k in tree if k.startswith(("ln", "final_norm",
                                                   "enc_norm"))]:
            off = 1.0 if not k.endswith("_b") else 0.0
            tree[k] = jnp.asarray(off + _normal(rng, tree[k].shape, 0.1))
    for k in ("b_in", "b_out"):
        jp["blocks"]["ffn"][k] = jnp.asarray(
            _normal(rng, jp["blocks"]["ffn"][k].shape, 0.1))
    tokens = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    frames = _normal(rng, (B, jc.encoder.n_frames, jc.d_model))
    return dict(jcfg=jc, jparams=jp, cfg=tc, tokens=tokens, frames=frames,
                params=t_tf.params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu"))


@pytest.fixture(scope="module")
def whisper():
    return _model()


def _j_fill(jc, jp, cache, frames):
    """The reference's cache with its cross_k / cross_v written from the
    encoder: per layer ``cross_kv`` of the layer cast to the compute type,
    cast to the cache's bf16 (what the prefill computes inside
    ``_whisper_decode_full``)."""
    enc = j_tf._encode(jc, jp, jnp.asarray(frames))
    ks, vs = [], []
    for l in range(jc.n_layers):
        bp = j_tf._cast_block(jc, jax.tree.map(lambda x: x[l],
                                               jp["blocks"]))
        k, v = j_attn.cross_kv(bp["cross"], enc, n_kv=jc.n_kv_heads,
                               head_dim=jc.resolved_head_dim)
        ks.append(k.astype(j_tf.CACHE_DTYPE))
        vs.append(v.astype(j_tf.CACHE_DTYPE))
    return dict(cache, cross_k=jnp.stack(ks), cross_v=jnp.stack(vs))


def _t_fill(cfg, params, cache, frames):
    """The port's counterpart of ``_j_fill``, written into the cache."""
    enc = t_tf._encode(cfg, params, frames, impl="torch")
    for l in range(cfg.n_layers):
        bp = t_common.cast_tree(t_tf._layer(params["blocks"], l),
                                t_tf._cdt(cfg))
        k, v = t_attn.cross_kv(bp["cross"], enc, n_kv=cfg.n_kv_heads,
                               head_dim=cfg.resolved_head_dim)
        cache["cross_k"][l] = k.to(t_tf.CACHE_DTYPE)
        cache["cross_v"][l] = v.to(t_tf.CACHE_DTYPE)
    return cache


def _j_decode(jc, jp, cache, tokens):
    step = jax.jit(lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t, pos))
    out = []
    for pos in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, pos:pos + 1]), pos)
        out.append(np.asarray(lg))
    return out


def _t_decode(cfg, params, cache, tokens):
    out = []
    for pos in range(STEPS):
        lg, cache = t_tf.decode_step(cfg, params, cache,
                                     tokens[:, pos:pos + 1], pos)
        out.append(lg.numpy())
    return out


class TestBlocks:
    @pytest.mark.parametrize("compute", ["float32", "bfloat16"])
    def test_plain_mlp(self, compute):
        """The tanh-GELU MLP with biases. fp32 compute: at the blocks'
        tolerance. bf16 compute (operands rounded to bf16 on both sides):
        at ``BF16_REL`` of the output's largest magnitude."""
        rng = np.random.default_rng(4)
        x = _normal(rng, (2, 7, 64))
        p = {"w_in": _normal(rng, (64, 128), 0.125),
             "b_in": _normal(rng, (128,), 0.1),
             "w_out": _normal(rng, (128, 64), 0.09),
             "b_out": _normal(rng, (64,), 0.1)}
        jdt, tdt = jnp.dtype(compute), getattr(torch, compute)
        want = j_mlp.mlp({k: jnp.asarray(v, jdt) for k, v in p.items()},
                         jnp.asarray(x, jdt), "gelu")
        got = t_mlp.mlp({k: _t(v).to(tdt) for k, v in p.items()},
                        _t(x).to(tdt), "gelu")
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        if compute == "float32":
            _close(got, want)
        else:
            assert _rel(got, want) <= BF16_REL

    def test_plain_mlp_init_layout(self):
        gen = torch.Generator().manual_seed(0)
        p = t_mlp.init_mlp(gen, 3, 64, 128, act="gelu")
        assert {k: tuple(v.shape) for k, v in p.items()} == {
            "w_in": (3, 64, 128), "b_in": (3, 128), "w_out": (3, 128, 64),
            "b_out": (3, 64)}
        assert not p["b_in"].any() and not p["b_out"].any()

    @pytest.mark.parametrize("bias", [False, True])
    @pytest.mark.parametrize("n_kv", [4, 2])
    def test_cross_kv_and_attention(self, bias, n_kv):
        rng = np.random.default_rng(5)
        dh, d = 16, 64
        p = {"wq": _normal(rng, (d, 4 * dh), 0.125),
             "wk": _normal(rng, (d, n_kv * dh), 0.125),
             "wv": _normal(rng, (d, n_kv * dh), 0.125),
             "wo": _normal(rng, (4 * dh, d), 0.125)}
        if bias:
            for name, w in (("bq", 4), ("bk", n_kv), ("bv", n_kv)):
                p[name] = _normal(rng, (w * dh,), 0.1)
        x, enc = _normal(rng, (2, 5, d)), _normal(rng, (2, 9, d))
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: _t(v) for k, v in p.items()}
        jkv = j_attn.cross_kv(jp, jnp.asarray(enc), n_kv=n_kv, head_dim=dh)
        tkv = t_attn.cross_kv(tp, _t(enc), n_kv=n_kv, head_dim=dh)
        for got, want in zip(tkv, jkv):
            assert tuple(got.shape) == want.shape == (2, 9, n_kv, dh)
            _close(got, want)
        want = j_attn.cross_attention(jp, jnp.asarray(x), jkv, n_heads=4,
                                      n_kv=n_kv, head_dim=dh)
        got = t_attn.cross_attention(tp, _t(x), tkv, n_heads=4, n_kv=n_kv,
                                     head_dim=dh)
        _close(got, want)
        # over a bf16 cache, as decode reads it
        jc = tuple(a.astype(jnp.bfloat16) for a in jkv)
        tc = tuple(a.to(torch.bfloat16) for a in tkv)
        want = j_attn.cross_attention(jp, jnp.asarray(x), jc, n_heads=4,
                                      n_kv=n_kv, head_dim=dh)
        got = t_attn.cross_attention(tp, _t(x), tc, n_heads=4, n_kv=n_kv,
                                     head_dim=dh)
        _close(got, want, atol=DECODE_ATOL)


class TestWhisper:
    def test_params_layout(self, whisper):
        """init_params draws the reference's tree (encoder and decoder
        stacks, ln*_b, cross, pos_emb sized by max_seq), and
        params_from_jax keeps it."""
        want = jax.eval_shape(lambda: j_tf.init_params(
            whisper["jcfg"], jax.random.PRNGKey(0), max_seq=MAX_SEQ))
        shapes = lambda t: jax.tree.map(  # noqa: E731
            lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
            t)
        drawn = t_tf.init_params(whisper["cfg"], seed=0, device="cpu",
                                 max_seq=MAX_SEQ)
        assert shapes(drawn) == shapes(want)
        assert shapes(whisper["params"]) == shapes(want)
        assert drawn["pos_emb"].shape == (MAX_SEQ, whisper["cfg"].d_model)
        assert t_tf.init_params(whisper["cfg"], seed=0, device="cpu")[
            "pos_emb"].shape[0] == 4096

    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_encode(self, whisper, impl):
        want = j_tf._encode(whisper["jcfg"], whisper["jparams"],
                            jnp.asarray(whisper["frames"]))
        got = t_tf._encode(whisper["cfg"], whisper["params"],
                           whisper["frames"], impl=impl)
        assert tuple(got.shape) == want.shape
        _close(got, want)

    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_prefill(self, whisper, impl):
        batch = {"tokens": whisper["tokens"], "frames": whisper["frames"]}
        want = jax.jit(lambda p, b: j_tf.prefill(whisper["jcfg"], p, b))(
            whisper["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
        got = t_tf.prefill(whisper["cfg"], whisper["params"], batch,
                           impl=impl)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape
        _close(got, want)

    def test_init_cache(self, whisper):
        want = j_tf.init_cache(whisper["jcfg"], B, MAX_SEQ, mode="specs")
        got = t_tf.init_cache(whisper["cfg"], B, MAX_SEQ, device="cpu")
        shapes = lambda t: jax.tree.map(  # noqa: E731
            lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
            t)
        assert shapes(got) == shapes(want)
        assert got["cross_k"].shape[2] == whisper["cfg"].encoder.n_frames
        assert not any(t.any() for t in jax.tree.leaves(got))

    def test_cross_cache_fill(self, whisper):
        want = _j_fill(whisper["jcfg"], whisper["jparams"], j_tf.init_cache(
            whisper["jcfg"], B, MAX_SEQ), whisper["frames"])
        got = _t_fill(whisper["cfg"], whisper["params"], t_tf.init_cache(
            whisper["cfg"], B, MAX_SEQ, device="cpu"), whisper["frames"])
        for k in ("cross_k", "cross_v"):
            _close(got[k], want[k], atol=DECODE_ATOL)

    def test_decode_over_the_same_cross_cache(self, whisper):
        """Decode steps against the reference's, both given the
        reference's filled cross cache."""
        jcache = _j_fill(whisper["jcfg"], whisper["jparams"],
                         j_tf.init_cache(whisper["jcfg"], B, MAX_SEQ),
                         whisper["frames"])
        tcache = t_tf.init_cache(whisper["cfg"], B, MAX_SEQ, device="cpu")
        for k in ("cross_k", "cross_v"):
            tcache[k] = t_tf.params_from_jax(
                {"x": np.asarray(jcache[k])}, device="cpu")["x"]
        want = _j_decode(whisper["jcfg"], whisper["jparams"], jcache,
                         whisper["tokens"])
        got = _t_decode(whisper["cfg"], whisper["params"], tcache,
                        whisper["tokens"])
        for g, w in zip(got, want):
            assert g.shape == w.shape == (B, 1, whisper["cfg"].vocab_size)
            _close(g, w, atol=DECODE_ATOL)

    def test_decode_matches_prefill(self, whisper):
        """Decode from a filled cache against the prefill of the same
        tokens, in the port and in the reference alike."""
        batch = {"tokens": whisper["tokens"], "frames": whisper["frames"]}
        cache = _t_fill(whisper["cfg"], whisper["params"], t_tf.init_cache(
            whisper["cfg"], B, MAX_SEQ, device="cpu"), whisper["frames"])
        got = _t_decode(whisper["cfg"], whisper["params"], cache,
                        whisper["tokens"])
        full = t_tf.prefill(whisper["cfg"], whisper["params"], batch,
                            impl="torch").numpy()
        jcache = _j_fill(whisper["jcfg"], whisper["jparams"],
                         j_tf.init_cache(whisper["jcfg"], B, MAX_SEQ),
                         whisper["frames"])
        ref = _j_decode(whisper["jcfg"], whisper["jparams"], jcache,
                        whisper["tokens"])
        jfull = np.asarray(j_tf.prefill(whisper["jcfg"], whisper["jparams"],
                                        {k: jnp.asarray(v)
                                         for k, v in batch.items()}))
        for pos in range(STEPS):
            assert _rel(got[pos][:, 0], full[:, pos]) <= DECODE_REL
            assert _rel(ref[pos][:, 0], jfull[:, pos]) <= DECODE_REL


class TestBf16Compute:
    """The serving dtype policy (fp32 parameters, bf16 compute)."""

    @pytest.fixture(scope="class")
    def whisper16(self):
        return _model(bf16=True)

    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_prefill(self, whisper16, impl):
        m = whisper16
        batch = {"tokens": m["tokens"], "frames": m["frames"]}
        want = jax.jit(lambda p, b: j_tf.prefill(m["jcfg"], p, b))(
            m["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
        got = t_tf.prefill(m["cfg"], m["params"], batch, impl=impl)
        assert _rel(got, want) <= BF16_REL

    def test_decode(self, whisper16):
        m = whisper16
        jcache = _j_fill(m["jcfg"], m["jparams"], j_tf.init_cache(
            m["jcfg"], B, MAX_SEQ), m["frames"])
        tcache = _t_fill(m["cfg"], m["params"], t_tf.init_cache(
            m["cfg"], B, MAX_SEQ, device="cpu"), m["frames"])
        want = _j_decode(m["jcfg"], m["jparams"], jcache, m["tokens"])
        got = _t_decode(m["cfg"], m["params"], tcache, m["tokens"])
        for g, w in zip(got, want):
            assert _rel(g, w) <= BF16_REL
