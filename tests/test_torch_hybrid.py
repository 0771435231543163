"""The SSM family (mamba2-2.7b) and the hybrid family (jamba-1.5-large-398b:
periods of Mamba-2 layers around one attention layer, a MoE FFN on every
other layer) of the PyTorch package against the reference on the CPU, at
their ``reduced()`` sizes (jamba: one period of 8 layers, 4 experts top-2):
the parameter and cache trees, ``prefill`` on both impls and a run of
``decode_step``s with the reference's weights carried across by
``params_from_jax``, Jamba's routing and balance loss, where its attention
layer sits, and both in their full configs' types (mamba2: fp32
parameters, bf16 compute; jamba: bf16 throughout). Inputs come from numpy
seeds and are handed to both.

Tolerances as tests/test_torch_lm.py's: fp32 at rtol 1e-4 with an absolute
1e-5 of the largest |logit| (1e-3 for decode, whose conv window and KV
cache are stored in bf16, as in the reference); bf16 compute at
``BF16_REL`` = 5e-2 of the largest |logit|, with the top-1 token agreeing
at ``TOP1`` of the positions (chip_smoke.py's DECODE_TOL) and every
position where it does not a near-tie: the port's pick within BF16_REL of
the reference's largest logit (on these seeds 22 of 24 prefill positions
and 7 of 8 decode positions agree for Jamba, all for mamba2). Jamba's bf16 routing
is compared first (near-ties may route apart, as tests/test_torch_moe.py
explains) and then pinned to the reference's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b")
RTOL = 1e-4
DECODE_ATOL = 1e-3
BF16_REL = 5e-2
TOP1 = 0.875
# a bf16 routing difference must be a near-tie (tests/test_torch_moe.py)
NEAR_TIE, ROUTE_AGREE = 0.1, 0.95
SEQ, STEPS = 12, 4


def _close(got, want, atol=1e-5, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _top1(got, want):
    return float((got.argmax(-1) == want.argmax(-1)).mean())


def _top1_held(got, want):
    """The top-1 token agrees at TOP1 of the positions, and where it does
    not, the port's pick is a near-tie in the reference's logits."""
    pick = np.take_along_axis(want, got.argmax(-1)[..., None], -1)[..., 0]
    margin = want.max(-1) - pick
    return (_top1(got, want) >= TOP1
            and bool((margin <= BF16_REL * np.abs(want).max()).all()))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _routes_of(run):
    """``run()``'s result and the experts of every reference route()."""
    seen, real = [], j_moe.route

    def spy(router_w, x2d, moe):
        out = real(router_w, x2d, moe)
        seen.append(np.asarray(out[0]))
        return out
    j_moe.route = spy
    try:
        return run(), seen
    finally:
        j_moe.route = real


def _tokens(cfg, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, SEQ)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """One reduced arch run through the reference (prefill op by op, so
    route calls are seen): params as numpy, a prompt, the prefill logits
    with each MoE layer's routing, and STEPS decode steps' logits."""
    jc = j_registry.get_config(name, reduced=True)
    jp = j_tf.init_params(jc, jax.random.PRNGKey(3))
    tokens = _tokens(jc)
    with jax.disable_jit():
        logits, routes = _routes_of(lambda: np.asarray(j_tf.prefill(
            jc, jp, {"tokens": jnp.asarray(tokens)})))
    step = jax.jit(lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t, pos))
    cache, steps = j_tf.init_cache(jc, 2, 16), []
    for pos in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, pos:pos + 1]), pos)
        steps.append(np.asarray(lg))
    return dict(cfg=t_registry.get_config(name, reduced=True), jcfg=jc,
                params=jax.tree.map(np.asarray, jp), tokens=tokens,
                prefill=logits, routes=routes, steps=steps,
                jcache=jax.tree.map(np.asarray, cache))


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return _reference_run(request.param)


class TestModel:
    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_prefill_matches_reference(self, lm, impl):
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        got = t_tf.prefill(lm["cfg"], params, {"tokens": lm["tokens"]},
                           impl=impl)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == lm["prefill"].shape
        _close(got, lm["prefill"])

    def test_decode_matches_reference(self, lm):
        """STEPS decode steps, and the cache after them: the SSM state
        (fp32), the conv window and KV cache (bf16)."""
        cfg = lm["cfg"]
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        cache = t_tf.init_cache(cfg, 2, 16, device="cpu")
        for pos in range(STEPS):
            got, cache = t_tf.decode_step(
                cfg, params, cache, lm["tokens"][:, pos:pos + 1], pos)
            assert tuple(got.shape) == (2, 1, cfg.vocab_size)
            _close(got, lm["steps"][pos], atol=DECODE_ATOL)
        ssm = cache["mamba"]["ssm"] if "mamba" in cache else cache["ssm"]
        want = (lm["jcache"]["mamba"]["ssm"] if "mamba" in cache
                else lm["jcache"]["ssm"])
        assert ssm.dtype == torch.float32
        _close(ssm, want, atol=DECODE_ATOL)

    def test_decode_agrees_with_prefill(self, lm):
        """The port's decode against its own prefill of the same tokens:
        the conv window and KV cache are stored in bf16 between steps (as
        in the reference), so the two differ by bf16 rounding, held as
        chip_smoke.py's DECODE_TOL holds them (5e-2 of the largest
        |logit|, top-1 agreeing at 0.875 of the positions)."""
        cfg = lm["cfg"]
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        full = t_tf.prefill(cfg, params, {"tokens": lm["tokens"]},
                            impl="torch").numpy()
        cache = t_tf.init_cache(cfg, 2, SEQ, device="cpu")
        steps = []
        for pos in range(SEQ):
            lg, cache = t_tf.decode_step(
                cfg, params, cache, lm["tokens"][:, pos:pos + 1], pos)
            steps.append(lg[:, 0].numpy())
        dec = np.stack(steps, 1)
        assert _rel(dec, full) <= BF16_REL
        assert _top1(dec, full) >= 0.875

    def test_params_layout(self, lm):
        """params_from_jax keeps every leaf's shape and type (the nested
        l0..l7 period of the hybrid too); init_params draws the same tree,
        the same for the same seed."""
        want = _shapes(lm["params"])
        assert _shapes(t_tf.params_from_jax(lm["params"],
                                            device="cpu")) == want
        drawn = t_tf.init_params(lm["cfg"], seed=0, device="cpu")
        assert _shapes(drawn) == want
        again = t_tf.init_params(lm["cfg"], seed=0, device="cpu")
        blocks = drawn["blocks"].get("l0", drawn["blocks"])
        assert torch.equal(blocks["mixer"]["in_proj"],
                           again["blocks"].get("l0", again["blocks"])
                           ["mixer"]["in_proj"])
        np.testing.assert_allclose(
            blocks["mixer"]["A_log"][0].numpy(),
            np.log(np.linspace(1.0, 16.0, blocks["mixer"]["A_log"].shape[1])),
            rtol=1e-6)

    def test_init_cache_layout(self, lm):
        want = _shapes(jax.tree.map(np.asarray, j_tf.init_cache(
            lm["jcfg"], 2, 16)))
        assert _shapes(t_tf.init_cache(lm["cfg"], 2, 16,
                                       device="cpu")) == want


@pytest.fixture(scope="module")
def jamba():
    return _reference_run("jamba-1.5-large-398b")


class TestJamba:
    def test_routing_equals_reference(self, jamba):
        params = t_tf.params_from_jax(jamba["params"], device="cpu")
        seen, real = [], t_moe.route

        def spy(router_w, x2d, moe):
            out = real(router_w, x2d, moe)
            seen.append(out[0].numpy())
            return out
        t_moe.route = spy
        try:
            t_tf.prefill(jamba["cfg"], params, {"tokens": jamba["tokens"]},
                         impl="torch")
        finally:
            t_moe.route = real
        assert len(seen) == len(jamba["routes"]) == 4
        for got, want in zip(seen, jamba["routes"]):
            assert np.array_equal(got, want)

    def test_backbone_returns_the_balance_loss(self, jamba):
        want_h, want_aux = j_tf.backbone(
            jamba["jcfg"], jax.tree.map(jnp.asarray, jamba["params"]),
            {"tokens": jnp.asarray(jamba["tokens"])})
        params = t_tf.params_from_jax(jamba["params"], device="cpu")
        h, aux = t_tf.backbone(jamba["cfg"], params,
                               {"tokens": jamba["tokens"]}, impl="torch")
        _close(h, want_h)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)

    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_attention_layer_in_the_middle_of_the_period(self, jamba, impl,
                                                         monkeypatch):
        """The layers run mamba x4, attention, mamba x3; under
        impl="cuda" the attention core goes to flash_attention, once a
        period, and under impl="torch" never."""
        order, flash = [], []
        real_mamba, real_attn = t_tf.mamba_block, t_tf.full_attention
        real_flash = t_attn.flash_attention
        monkeypatch.setattr(t_tf, "mamba_block", lambda *a, **k: (
            order.append("mamba"), real_mamba(*a, **k))[1])
        monkeypatch.setattr(t_tf, "full_attention", lambda *a, **k: (
            order.append("attn"), real_attn(*a, **k))[1])
        monkeypatch.setattr(t_attn, "flash_attention", lambda *a, **k: (
            flash.append(a[0].shape), real_flash(*a, **k))[1])
        params = t_tf.params_from_jax(jamba["params"], device="cpu")
        t_tf.prefill(jamba["cfg"], params, {"tokens": jamba["tokens"]},
                     impl=impl)
        assert order == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
        assert len(flash) == (1 if impl == "cuda" else 0)
        assert [i for i in range(16) if t_tf._jamba_is_attn(
            jamba["cfg"], i)] == [4, 12]
        for i in range(16):
            assert t_tf._jamba_is_attn(jamba["cfg"], i) == \
                j_tf._jamba_is_attn(jamba["jcfg"], i)

    def test_two_periods(self):
        """Two periods: each layer's slice of the stacked period, the KV
        cache a period and seven conv/ssm states a period."""
        name = "jamba-1.5-large-398b"
        jc = dataclasses.replace(j_registry.get_config(name, reduced=True),
                                 n_layers=16)
        tc = dataclasses.replace(t_registry.get_config(name, reduced=True),
                                 n_layers=16)
        jp = j_tf.init_params(jc, jax.random.PRNGKey(2))
        tokens = _tokens(jc, seed=9)
        want = np.asarray(jax.jit(lambda p, t: j_tf.prefill(
            jc, p, {"tokens": t}))(jp, jnp.asarray(tokens)))
        params = t_tf.params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")
        assert params["blocks"]["l4"]["mixer"]["wq"].shape[0] == 2
        _close(t_tf.prefill(tc, params, {"tokens": tokens}, impl="torch"),
               want)
        step = jax.jit(lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t,
                                                             pos))
        jcache, cache = j_tf.init_cache(jc, 2, 8), t_tf.init_cache(
            tc, 2, 8, device="cpu")
        assert tuple(cache["ssm"].shape[:3]) == (2, 7, 2)
        for pos in range(2):
            lg, jcache = step(jp, jcache, jnp.asarray(tokens[:, pos:pos + 1]),
                              pos)
            got, cache = t_tf.decode_step(tc, params, cache,
                                          tokens[:, pos:pos + 1], pos)
            _close(got, lg, atol=DECODE_ATOL)


class _Routes:
    """Records each route() call's experts on both sides and can pin the
    port's to the reference's (tests/test_torch_moe.py's)."""

    def __init__(self, monkeypatch):
        self.ref, self.port, self.pin = [], [], None
        real_j, real_t = j_moe.route, t_moe.route

        def ref(router_w, x2d, moe):
            out = real_j(router_w, x2d, moe)
            self.ref.append(np.asarray(out[0]))
            return out

        def port(router_w, x2d, moe):
            top_e, top_p, aux = real_t(router_w, x2d, moe)
            probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
            self.port.append((top_e.numpy(), probs.numpy()))
            if self.pin is not None:
                top_e = torch.tensor(self.pin.pop(0), dtype=torch.int64)
                top_p = probs.gather(1, top_e)
                top_p = top_p / top_p.sum(dim=-1, keepdim=True)
            return top_e, top_p, aux
        monkeypatch.setattr(j_moe, "route", ref)
        monkeypatch.setattr(t_moe, "route", port)

    def agreement(self):
        same = total = 0
        for want, (got, probs) in zip(self.ref, self.port):
            hit = (want[:, :, None] == got[:, None, :]).any(-1)
            same, total = same + int(hit.sum()), total + hit.size
            for t, i in zip(*np.nonzero(~hit)):
                kth = probs[t, got[t]].min()
                if (kth - probs[t, want[t, i]]) / kth > NEAR_TIE:
                    return same / total, False
        return same / total, True


def _full_types(name):
    """The reduced configs in the full config's parameter and compute
    types (mamba2: fp32 parameters, bf16 compute; jamba: bf16)."""
    full = j_registry.get_config(name)
    jc = dataclasses.replace(j_registry.get_config(name, reduced=True),
                             dtype=full.dtype)
    tc = dataclasses.replace(t_registry.get_config(name, reduced=True),
                             dtype=t_base.DTypePolicy(**dataclasses.asdict(
                                 full.dtype)))
    return jc, tc


def _bf16_params(jc, seed):
    """The reference's params with every norm scale and the Mamba
    constants (D, dt bias, conv bias) drawn around their init values."""
    jp = j_tf.init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def move(t, base):
        return jnp.asarray(base + rng.standard_normal(t.shape) * 0.1,
                           t.dtype)
    jp["final_norm"] = move(jp["final_norm"], 1.0)
    layers = (jp["blocks"].values() if "l0" in jp["blocks"]
              else [jp["blocks"]])
    for bp in layers:
        for k in ("ln1", "ln2"):
            if k in bp:
                bp[k] = move(bp[k], 1.0)
        m = bp["mixer"]
        if "D" in m:
            for k, base in (("norm", 1.0), ("D", 1.0), ("dt_bias", 0.0),
                            ("conv_b", 0.0)):
                m[k] = move(m[k], base)
    return jp


@pytest.mark.parametrize("name", ARCHS)
def test_full_config_types(name, monkeypatch):
    """Prefill on both impls and STEPS decode steps in the full configs'
    types against the reference (op by op, so its routing is seen): within
    BF16_REL, the top-1 token held by ``_top1_held``. Jamba's routing agrees
    but for near-ties and is then pinned to the reference's."""
    jc, tc = _full_types(name)
    jp = _bf16_params(jc, 4)
    params = t_tf.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    pdt = getattr(torch, jc.dtype.param_dtype)
    layer = params["blocks"].get("l0", params["blocks"])
    assert layer["mixer"]["A_log"].dtype == pdt
    assert layer["mixer"]["in_proj"].dtype == pdt
    tokens = _tokens(jc, seed=6)
    routes = _Routes(monkeypatch)
    with jax.disable_jit():
        want = np.asarray(j_tf.prefill(jc, jp, {"tokens": jnp.asarray(
            tokens)}))
        jcache, steps = j_tf.init_cache(jc, 2, 8), []
        for pos in range(STEPS):
            lg, jcache = j_tf.decode_step(
                jc, jp, jcache, jnp.asarray(tokens[:, pos:pos + 1]), pos)
            steps.append(np.asarray(lg))
    ref_routes = list(routes.ref)
    n_moe = len(ref_routes) // (1 + STEPS)
    for impl in ("cuda", "torch"):
        routes.ref, routes.port = ref_routes[:n_moe], []
        got = t_tf.prefill(tc, params, {"tokens": tokens}, impl=impl)
        if n_moe:
            share, near_ties = routes.agreement()
            assert near_ties and share >= ROUTE_AGREE, (impl, share)
            routes.pin = list(ref_routes[:n_moe])
            got = t_tf.prefill(tc, params, {"tokens": tokens}, impl=impl)
            assert not routes.pin
            routes.pin = None
        got = got.numpy()
        assert _rel(got, want) <= BF16_REL, impl
        assert _top1_held(got, want), (impl, _top1(got, want))
    routes.ref, routes.port = ref_routes[n_moe:], []
    routes.pin = list(ref_routes[n_moe:]) if n_moe else None
    tcache, dec = t_tf.init_cache(tc, 2, 8, device="cpu"), []
    for pos in range(STEPS):
        got, tcache = t_tf.decode_step(tc, params, tcache,
                                       tokens[:, pos:pos + 1], pos)
        dec.append(got.numpy())
        assert _rel(dec[-1], steps[pos]) <= BF16_REL
    assert not routes.pin
    dec, steps = np.concatenate(dec, 1), np.concatenate(steps, 1)
    assert _top1_held(dec, steps), _top1(dec, steps)


def test_layer_cast_rounds_the_mamba_constants():
    """mamba2's fp32 parameters are cast to bf16 a layer before use, A_log,
    dt_bias, D, conv and norm included (the reference's _cast_block): the
    same parameters rounded to bf16 beforehand give the same bits, and
    A_log kept in fp32 does not."""
    _, tc = _full_types("mamba2-2.7b")
    params = t_tf.init_params(tc, seed=1, device="cpu")
    for bp in [params["blocks"]["mixer"]]:
        bp["A_log"] += 0.01 * torch.arange(bp["A_log"].shape[1]) / 7
        bp["dt_bias"] += 0.123
    tokens = {"tokens": _tokens(tc)}
    got = t_tf.prefill(tc, params, tokens, impl="torch")
    rounded = {k: (v if k != "blocks" else {
        kk: ({m: w.to(torch.bfloat16).float() for m, w in vv.items()}
             if isinstance(vv, dict) else vv.to(torch.bfloat16).float())
        for kk, vv in v.items()}) for k, v in params.items()}
    assert torch.equal(t_tf.prefill(tc, rounded, tokens, impl="torch"), got)
    real = t_tf.cast_tree

    def keep_a_log(tree, dtype):
        out = real(tree, dtype)
        if "mixer" in tree:
            out["mixer"]["A_log"] = tree["mixer"]["A_log"]
        return out
    t_tf.cast_tree = keep_a_log
    try:
        assert not torch.equal(t_tf.prefill(tc, params, tokens,
                                            impl="torch"), got)
    finally:
        t_tf.cast_tree = real
