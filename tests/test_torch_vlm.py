"""The VLM family (pixtral-12b) of the PyTorch package against the
reference on the CPU: prefill with random patch embeddings spliced over
the first token embeddings (both impls), the identity splice (the
prompt's own first embeddings) equal to the dense family's prefill of the
same parameters, decode (the dense family's path, as in the reference),
and the refusal of a prompt shorter than the patches. The reference's
weights are carried across by ``params_from_jax``; inputs come from numpy
seeds and are handed to both.

Tolerances, as tests/test_torch_lm.py's: fp32 on both sides, rtol 1e-4
with an absolute term of 1e-5 (prefill) and 1e-3 (decode, bf16 cache) in
units of the output's largest magnitude (at least 1); the serving
policy's bf16 compute at ``BF16_REL`` = 5e-2 of max |logit|.
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
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

ARCH = "pixtral-12b"
RTOL, ATOL, DECODE_ATOL, BF16_REL = 1e-4, 1e-5, 1e-3, 5e-2
B, S, STEPS = 2, 12, 3


def _close(got, want, atol=ATOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol * scale)


def _model(bf16=False):
    jc = j_registry.get_config(ARCH, reduced=True)
    tc = t_registry.get_config(ARCH, reduced=True)
    if bf16:
        pol = dict(param_dtype="float32", compute_dtype="bfloat16")
        jc = dataclasses.replace(jc, dtype=j_base.DTypePolicy(**pol))
        tc = dataclasses.replace(tc, dtype=t_base.DTypePolicy(**pol))
    jp = j_tf.init_params(jc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal(
        (B, jc.vision.n_patches, jc.d_model)).astype(np.float32)
    return dict(jcfg=jc, jparams=jp, cfg=tc, tokens=tokens, patches=patches,
                params=t_tf.params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu"))


@pytest.fixture(scope="module")
def pixtral():
    return _model()


def _j_prefill(m, batch):
    return np.asarray(jax.jit(lambda p, b: j_tf.prefill(m["jcfg"], p, b))(
        m["jparams"], {k: jnp.asarray(v) for k, v in batch.items()}))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_prefill_with_a_random_splice(pixtral, impl):
    batch = {"tokens": pixtral["tokens"], "patch_embeds": pixtral["patches"]}
    want = _j_prefill(pixtral, batch)
    got = t_tf.prefill(pixtral["cfg"], pixtral["params"], batch, impl=impl)
    assert tuple(got.shape) == want.shape == (B, S, pixtral["cfg"].vocab_size)
    _close(got, want)


def test_the_splice_reaches_the_logits(pixtral):
    """Every position differs from the dense family's prefill of the same
    tokens: the spliced ones, and causally all after them."""
    cfg = pixtral["cfg"]
    dense = dataclasses.replace(cfg, family="dense", vision=None)
    got = t_tf.prefill(cfg, pixtral["params"], {
        "tokens": pixtral["tokens"], "patch_embeds": pixtral["patches"]},
        impl="torch")
    plain = t_tf.prefill(dense, pixtral["params"],
                         {"tokens": pixtral["tokens"]}, impl="torch")
    assert bool((got != plain).any(dim=-1).all())


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_identity_splice_equals_the_dense_prefill(pixtral, impl):
    """patch_embeds = the prompt's own first P token embeddings: bitwise
    the dense family's prefill of the same params."""
    cfg, params = pixtral["cfg"], pixtral["params"]
    P = cfg.vision.n_patches
    own = params["embed"][torch.from_numpy(pixtral["tokens"][:, :P]).long()]
    got = t_tf.prefill(cfg, params, {"tokens": pixtral["tokens"],
                                     "patch_embeds": own}, impl=impl)
    dense = dataclasses.replace(cfg, family="dense", vision=None)
    want = t_tf.prefill(dense, params, {"tokens": pixtral["tokens"]},
                        impl=impl)
    assert torch.equal(got, want)


def test_decode_matches_reference(pixtral):
    """Decode is the dense family's: the cache and steps against the
    reference's ``decode_step``."""
    jc, jp = pixtral["jcfg"], pixtral["jparams"]
    step = jax.jit(lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t, pos))
    jcache = j_tf.init_cache(jc, B, 16)
    cache = t_tf.init_cache(pixtral["cfg"], B, 16, device="cpu")
    assert sorted(cache) == sorted(jcache) == ["attn"]
    for pos in range(STEPS):
        tok = pixtral["tokens"][:, pos:pos + 1]
        want, jcache = step(jp, jcache, jnp.asarray(tok), pos)
        got, cache = t_tf.decode_step(pixtral["cfg"], pixtral["params"],
                                      cache, tok, pos)
        _close(got, want, atol=DECODE_ATOL)


def test_a_prompt_shorter_than_the_patches_is_refused(pixtral):
    cfg = pixtral["cfg"]
    P = cfg.vision.n_patches
    short = {"tokens": pixtral["tokens"][:, :P - 1],
             "patch_embeds": pixtral["patches"]}
    with pytest.raises(ValueError, match="patch embeddings do not fit"):
        t_tf.prefill(cfg, pixtral["params"], short, impl="torch")
    with pytest.raises(TypeError):                 # the reference's refusal
        j_tf.prefill(pixtral["jcfg"], pixtral["jparams"],
                     {k: jnp.asarray(v) for k, v in short.items()})


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_bf16_compute(impl):
    m = _model(bf16=True)
    batch = {"tokens": m["tokens"], "patch_embeds": m["patches"]}
    want = _j_prefill(m, batch)
    got = t_tf.prefill(m["cfg"], m["params"], batch, impl=impl).numpy()
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= BF16_REL
