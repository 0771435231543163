"""The MoE family of the PyTorch package against the reference on the CPU:
MoE routing and dispatch (``models.moe``), Multi-head Latent Attention
(``models.mla``; its prefill core also through the ``flash_attention``
kernel's plain version, v at its own width), and ``prefill`` /
``decode_step`` of deepseek-v2-lite-16b and deepseek-v3-671b
(``reduced=True``) with the reference's weights carried across by
``params_from_jax``. Inputs come from numpy seeds and are handed to both.

Routing is compared first and exactly (``top_e``, the dispatch slots):
a token whose top-k probabilities nearly tie could route differently in
the two frameworks, whose fp32 sums run in other orders, and would then
differ by a whole expert's output; on these seeds none does. Outputs are
then held as tests/test_torch_lm.py holds the dense family: fp32 at rtol
1e-4 with an absolute 1e-5 of the output's largest magnitude (1e-3 for
decode, whose latent cache is bf16 as in the reference), bf16 compute at
``BF16_REL`` = 5e-2 of the largest |logit|. MLA's absorbed decode against
its own full path is held at tests/test_model_components.py's 1e-4.
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
from repro.models import mla as j_mla  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

MOE_ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
RTOL = 1e-4
DECODE_ATOL = 1e-3
BF16_REL = 5e-2
D = 32


def _close(got, want, atol=1e-5, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _j(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _t(tree, dtype=None):
    def leaf(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dtype) if dtype is not None else t
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    return leaf(tree)


def _moe_cfg(**kw):
    base = dict(num_experts=8, num_shared=1, top_k=2, d_ff_expert=24,
                d_ff_shared=40, capacity_factor=1.25)
    base.update(kw)
    return j_base.MoEConfig(**base), t_base.MoEConfig(**base)


def _moe_params(rng, moe, d=D):
    E, F = moe.num_experts, moe.d_ff_expert
    p = {"router": _normal(rng, (d, E), d ** -0.5),
         "w_gate": _normal(rng, (E, d, F), d ** -0.5),
         "w_up": _normal(rng, (E, d, F), d ** -0.5),
         "w_down": _normal(rng, (E, F, d), F ** -0.5)}
    if moe.num_shared:
        fs = moe.d_ff_shared
        p["shared"] = {"w_gate": _normal(rng, (d, fs), d ** -0.5),
                       "w_up": _normal(rng, (d, fs), d ** -0.5),
                       "w_down": _normal(rng, (fs, d), fs ** -0.5)}
    return p


# (seed, B, S, MoE overrides): nothing dropped; capacity drops (a small
# capacity factor: 4 experts at 64 pairs, 16 slots each); top-1 routing
MOE_CASES = {"fits": (0, 2, 16, {}),
             "drops": (1, 2, 32, dict(num_experts=4, capacity_factor=0.5)),
             "top1": (2, 1, 24, dict(top_k=1, num_shared=0))}


@pytest.fixture(scope="module", params=sorted(MOE_CASES))
def moe_case(request):
    seed, B, S, kw = MOE_CASES[request.param]
    jm, tm = _moe_cfg(**kw)
    rng = np.random.default_rng(seed)
    p = _moe_params(rng, jm)
    x = _normal(rng, (B, S, D))
    return dict(name=request.param, jm=jm, tm=tm, p=p, x=x, T=B * S)


def _dropped(dest, moe, cap):
    return int((np.asarray(dest) == moe.num_experts * cap).sum())


class TestMoE:
    def test_capacity(self):
        for T in (1, 16, 100, 8192):
            for kw in ({}, dict(num_experts=64, top_k=6)):
                jm, tm = _moe_cfg(**kw)
                assert t_moe.capacity(T, tm) == j_moe.capacity(T, jm)
        _, tm = _moe_cfg(num_experts=64, top_k=6)
        assert t_moe.capacity(8192, tm) == 960
        assert t_moe.capacity(16, tm) == 8 and t_moe.capacity(1, tm) == 8

    def test_route_and_dispatch_equal_reference(self, moe_case):
        c = moe_case
        x2d = c["x"].reshape(c["T"], D)
        je, jp, jaux = j_moe.route(jnp.asarray(c["p"]["router"]),
                                   jnp.asarray(x2d), c["jm"])
        te, tp, taux = t_moe.route(_t(c["p"]["router"]), _t(x2d), c["tm"])
        assert np.array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
        cap = t_moe.capacity(c["T"], c["tm"])
        jd = j_moe.dispatch_indices(je, c["T"], c["jm"], cap)
        td = t_moe.dispatch_indices(te, c["T"], c["tm"], cap)
        for got, want in zip(td, jd):
            assert np.array_equal(got.numpy(), np.asarray(want))
        drops = _dropped(td[0], c["tm"], cap)
        assert (drops > 0) == (c["name"] == "drops")

    @pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_gather"])
    def test_ffn_matches_reference(self, moe_case, fn):
        c = moe_case
        want, jaux = getattr(j_moe, fn)(_j(c["p"]), jnp.asarray(c["x"]),
                                        c["jm"])
        got, taux = getattr(t_moe, fn)(_t(c["p"]), _t(c["x"]), c["tm"])
        _close(got, want)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    def test_scatter_equals_gather(self, moe_case):
        c = moe_case
        a, _ = t_moe.moe_ffn(_t(c["p"]), _t(c["x"]), c["tm"])
        b, _ = t_moe.moe_ffn_gather(_t(c["p"]), _t(c["x"]), c["tm"])
        _close(a, b.numpy(), atol=1e-6, rtol=1e-5)

    def test_dense_oracle(self, moe_case):
        """Where nothing overflows, the capacity dispatch equals every
        expert run on every token; where pairs drop, it does not."""
        c = moe_case
        want = j_moe.moe_ffn_dense_oracle(_j(c["p"]), jnp.asarray(c["x"]),
                                          c["jm"])
        oracle = t_moe.moe_ffn_dense_oracle(_t(c["p"]), _t(c["x"]), c["tm"])
        _close(oracle, want)
        got, _ = t_moe.moe_ffn(_t(c["p"]), _t(c["x"]), c["tm"])
        if c["name"] == "drops":
            assert not torch.allclose(got, oracle, rtol=1e-3, atol=1e-3)
        else:
            _close(got, oracle.numpy(), atol=1e-6, rtol=1e-5)

    def test_apply_muxes_on_dispatch(self, moe_case):
        c = moe_case
        for dispatch, fn in (("scatter", t_moe.moe_ffn),
                             ("gather", t_moe.moe_ffn_gather)):
            cfg = dataclasses.replace(c["tm"], dispatch=dispatch)
            got, _ = t_moe.moe_apply(_t(c["p"]), _t(c["x"]), cfg)
            assert torch.equal(got, fn(_t(c["p"]), _t(c["x"]), cfg)[0])

    @pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_gather"])
    def test_bf16(self, fn):
        """bf16 tokens and experts (the router upcast to fp32 inside
        route), the routing equal first."""
        jm, tm = _moe_cfg()
        rng = np.random.default_rng(9)
        p, x = _moe_params(rng, jm), _normal(rng, (2, 16, D))
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
        tp = _t(p, torch.bfloat16)
        je, _, _ = j_moe.route(jp["router"], jnp.asarray(
            x.reshape(-1, D), jnp.bfloat16), jm)
        te, _, _ = t_moe.route(tp["router"], _t(x, torch.bfloat16).reshape(
            -1, D), tm)
        assert np.array_equal(te.numpy(), np.asarray(je))
        want, _ = getattr(j_moe, fn)(jp, jnp.asarray(x, jnp.bfloat16), jm)
        got, _ = getattr(t_moe, fn)(tp, _t(x, torch.bfloat16), tm)
        assert got.dtype == torch.bfloat16
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) \
            <= BF16_REL

    def test_init_layout(self):
        jm, tm = _moe_cfg()
        jp = j_moe.init_moe(jax.random.PRNGKey(0), D, jm)
        tp = t_moe.init_moe(torch.Generator().manual_seed(0), 3, D, tm)

        def shapes(tree, lead=()):
            if isinstance(tree, dict):
                return {k: shapes(v, lead) for k, v in tree.items()}
            return lead + tuple(tree.shape), str(tree.dtype)[-7:]
        assert shapes(tp) == shapes(jax.tree.map(np.asarray, jp), (3,))
        assert tp["router"].dtype == torch.float32


def _mla_cfg(q_lora=0):
    kw = dict(kv_lora_rank=16, q_lora_rank=q_lora, qk_nope_head_dim=8,
              qk_rope_head_dim=4, v_head_dim=6)
    return j_base.MLAConfig(**kw), t_base.MLAConfig(**kw)


H = 3


def _mla_params(rng, mla, d=D):
    qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    r = mla.kv_lora_rank
    p = {"w_dkv": _normal(rng, (d, r), d ** -0.5),
         "w_kr": _normal(rng, (d, mla.qk_rope_head_dim), d ** -0.5),
         "w_uk": _normal(rng, (r, H * mla.qk_nope_head_dim), r ** -0.5),
         "w_uv": _normal(rng, (r, H * mla.v_head_dim), r ** -0.5),
         "wo": _normal(rng, (H * mla.v_head_dim, d), 0.3),
         "kv_norm": 1 + _normal(rng, (r,), 0.1)}
    if mla.q_lora_rank:
        p["w_dq"] = _normal(rng, (d, mla.q_lora_rank), d ** -0.5)
        p["w_uq"] = _normal(rng, (mla.q_lora_rank, H * qk),
                            mla.q_lora_rank ** -0.5)
        p["q_norm"] = 1 + _normal(rng, (mla.q_lora_rank,), 0.1)
    else:
        p["wq"] = _normal(rng, (d, H * qk), d ** -0.5)
    return p


class TestMLA:
    @pytest.mark.parametrize("q_lora", [0, 12])
    @pytest.mark.parametrize("impl,chunk_q", [("torch", 0), ("torch", 8),
                                              ("cuda", 0)])
    def test_full_matches_reference(self, q_lora, impl, chunk_q):
        """Both plain branches (the [S, S] softmax, query blocks of 8) and
        impl="cuda": q and k 12 wide, v at its own 6 through the flash
        kernel (its plain version here)."""
        jm, tm = _mla_cfg(q_lora)
        rng = np.random.default_rng(20 + q_lora + chunk_q)
        p, x = _mla_params(rng, jm), _normal(rng, (2, 32, D))
        kw = dict(n_heads=H, rope_theta=1e4, chunk_q=chunk_q)
        want, (jc, jk) = j_mla.mla_full(_j(p), jnp.asarray(x), mla=jm, **kw)
        before = t_flash.launches
        got, (tc, tk) = t_mla.mla_full(_t(p), _t(x), mla=tm, impl=impl, **kw)
        assert t_flash.launches == before          # no launch on the CPU
        _close(got, want)
        _close(tc, jc)
        _close(tk, jk)

    def test_flash_core_pads_v(self, monkeypatch):
        """impl="cuda" pads v no more: it hands flash_attention q and k
        nope + rope wide and v at its own width (v_head_dim), each
        contiguous [B,H,S,*], v equal to the layer's own (only the wrapper
        pads, for its cuda_core kernel)."""
        jm, tm = _mla_cfg()
        rng = np.random.default_rng(3)
        p, x = _mla_params(rng, jm), _normal(rng, (1, 10, D))
        seen = []

        def spy(q, k, v, *, causal=True):
            seen.append((q, k, v, causal))
            return t_flash.flash_attention_ref(q, k, v, causal=causal)
        monkeypatch.setattr(t_mla, "flash_attention", spy)
        t_mla.mla_full(_t(p), _t(x), n_heads=H, mla=tm, impl="cuda")
        (q, k, v, causal), = seen
        assert causal
        for t, w in ((q, 12), (k, 12), (v, 6)):
            assert tuple(t.shape) == (1, H, 10, w) and t.is_contiguous()
        c_kv = t_mla.rms_norm(t_mla.matmul(_t(x), _t(p["w_dkv"])),
                              _t(p["kv_norm"]))
        want_v = t_mla.matmul(c_kv, _t(p["w_uv"])).reshape(1, 10, H, 6)
        assert torch.equal(v, want_v.transpose(1, 2))
        assert torch.equal(k[:, 0, :, 8:], k[:, 2, :, 8:])   # shared rope

    @pytest.mark.parametrize("causal", [True, False])
    def test_cuda_impl_at_deepseek_widths_matches_reference(self, causal):
        """impl="cuda" at deepseek's head widths (q and k 128 nope + 64
        rope, v 128: the wgmma kernel's (192, 128) on a card; its plain
        version here) against the reference's einsum core."""
        kw = dict(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128)
        jm, tm = j_base.MLAConfig(**kw), t_base.MLAConfig(**kw)
        assert t_flash.flash_variant(torch.bfloat16, 192, 128) == "wgmma"
        rng = np.random.default_rng(50 + causal)
        p, x = _mla_params(rng, jm), _normal(rng, (1, 24, D))
        want, _ = j_mla.mla_full(_j(p), jnp.asarray(x), mla=jm, n_heads=H,
                                 causal=causal)
        got, _ = t_mla.mla_full(_t(p), _t(x), mla=tm, n_heads=H,
                                causal=causal, impl="cuda")
        _close(got, want)

    def test_bad_impl(self):
        jm, tm = _mla_cfg()
        with pytest.raises(ValueError, match="impl"):
            t_mla.mla_full({}, torch.zeros(1, 2, D), n_heads=H, mla=tm,
                           impl="pallas")

    @pytest.mark.parametrize("q_lora", [0, 12])
    def test_decode_matches_full(self, q_lora):
        """Absorbed decode at position t == row t of the materialized
        attention, fp32 caches (tests/test_model_components.py's case)."""
        jm, tm = _mla_cfg(q_lora)
        rng = np.random.default_rng(30 + q_lora)
        p, x = _t(_mla_params(rng, jm)), _t(_normal(rng, (2, 8, D)))
        full, _ = t_mla.mla_full(p, x, n_heads=H, mla=tm, impl="torch")
        ckv = torch.zeros(2, 8, tm.kv_lora_rank)
        kr = torch.zeros(2, 8, tm.qk_rope_head_dim)
        ys = []
        for t in range(8):
            y, ckv, kr = t_mla.mla_decode(p, x[:, t:t + 1], ckv, kr, t,
                                          n_heads=H, mla=tm)
            ys.append(y)
        np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                                   rtol=1e-4, atol=1e-4)
        with pytest.raises(ValueError, match="pos"):
            t_mla.mla_decode(p, x[:, :1], ckv, kr, 8, n_heads=H, mla=tm)

    def test_decode_matches_reference(self):
        """Three steps into bf16 caches, as the model's decode runs."""
        jm, tm = _mla_cfg(12)
        rng = np.random.default_rng(40)
        p = _mla_params(rng, jm)
        jp, tp = _j(p), _t(p)
        jc = jnp.zeros((2, 8, 16), jnp.bfloat16)
        jk = jnp.zeros((2, 8, 4), jnp.bfloat16)
        tc = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
        tk = torch.zeros(2, 8, 4, dtype=torch.bfloat16)
        for pos in range(3):
            x = _normal(rng, (2, 1, D))
            want, jc, jk = j_mla.mla_decode(jp, jnp.asarray(x), jc, jk, pos,
                                            n_heads=H, mla=jm)
            got, tc, tk = t_mla.mla_decode(tp, _t(x), tc, tk, pos,
                                           n_heads=H, mla=tm)
            _close(got, want, atol=DECODE_ATOL)
            assert np.array_equal(tc.float().numpy(),
                                  np.asarray(jc, np.float32))
            assert np.array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))


def _q_lora(cfg, base):
    """deepseek-v3's query compression at the reduced size."""
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, q_lora_rank=24))


# the model cases: each reduced MoE arch, and deepseek-v3 with its query
# compression (the reduced config drops it)
MODEL_CASES = {"deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", False),
               "deepseek-v3-671b": ("deepseek-v3-671b", False),
               "deepseek-v3-671b+q_lora": ("deepseek-v3-671b", True)}


def _configs(case):
    name, q_lora = MODEL_CASES[case]
    jc = j_registry.get_config(name, reduced=True)
    tc = t_registry.get_config(name, reduced=True)
    if q_lora:
        jc, tc = _q_lora(jc, j_base), _q_lora(tc, t_base)
    return jc, tc


def _routes(cfg, run):
    """The (layer, top_e) of every route() call made by ``run()``."""
    seen = []
    real = j_moe.route

    def spy(router_w, x2d, moe):
        out = real(router_w, x2d, moe)
        seen.append(np.asarray(out[0]))
        return out
    j_moe.route = spy
    try:
        out = run()
    finally:
        j_moe.route = real
    return out, seen


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def lm(request):
    """One reduced MoE arch run through the reference (op by op, so route
    calls are seen): params as numpy, a prompt, the prefill logits with
    each MoE layer's routing, and three decode steps' logits."""
    jc, tc = _configs(request.param)
    jp = j_tf.init_params(jc, jax.random.PRNGKey(3))
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 12)).astype(np.int32)
    with jax.disable_jit():
        logits, routes = _routes(jc, lambda: np.asarray(j_tf.prefill(
            jc, jp, {"tokens": jnp.asarray(tokens)})))
    step = jax.jit(lambda p, c, t, pos: j_tf.decode_step(jc, p, c, t, pos))
    cache, steps = j_tf.init_cache(jc, 2, 16), []
    for pos in range(3):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, pos:pos + 1]), pos)
        steps.append(np.asarray(lg))
    return dict(cfg=tc, jcfg=jc, params=jax.tree.map(np.asarray, jp),
                tokens=tokens, prefill=logits, routes=routes, steps=steps)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


class TestMoEModel:
    def test_routing_equals_reference(self, lm):
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        seen = []
        real = t_moe.route

        def spy(router_w, x2d, moe):
            out = real(router_w, x2d, moe)
            seen.append(out[0].numpy())
            return out
        t_moe.route = spy
        try:
            t_tf.prefill(lm["cfg"], params, {"tokens": lm["tokens"]},
                         impl="torch")
        finally:
            t_moe.route = real
        assert len(seen) == len(lm["routes"]) == lm["cfg"].n_layers - 1
        for got, want in zip(seen, lm["routes"]):
            assert np.array_equal(got, want)

    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_prefill_matches_reference(self, lm, impl):
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        got = t_tf.prefill(lm["cfg"], params, {"tokens": lm["tokens"]},
                           impl=impl)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == lm["prefill"].shape
        _close(got, lm["prefill"])

    def test_backbone_returns_the_balance_loss(self, lm):
        jc = lm["jcfg"]
        want_h, want_aux = j_tf.backbone(jc, _j(lm["params"]),
                                         {"tokens": jnp.asarray(
                                             lm["tokens"])})
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        h, aux = t_tf.backbone(lm["cfg"], params, {"tokens": lm["tokens"]},
                               impl="torch")
        _close(h, want_h)
        assert aux.dtype == torch.float32
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)

    def test_decode_matches_reference(self, lm):
        cfg = lm["cfg"]
        params = t_tf.params_from_jax(lm["params"], device="cpu")
        cache = t_tf.init_cache(cfg, 2, 16, device="cpu")
        assert sorted(cache) == ["dense", "moe"]
        assert cache["moe"]["ckv"].dtype == torch.bfloat16
        for pos in range(3):
            got, cache = t_tf.decode_step(
                cfg, params, cache, lm["tokens"][:, pos:pos + 1], pos)
            _close(got, lm["steps"][pos], atol=DECODE_ATOL)

    def test_params_layout(self, lm):
        """params_from_jax keeps every leaf's shape and type; init_params
        draws the same tree (dense_blocks, blocks, deepseek-v3's mtp)."""
        want = _shapes(lm["params"])
        assert _shapes(t_tf.params_from_jax(lm["params"],
                                            device="cpu")) == want
        drawn = t_tf.init_params(lm["cfg"], seed=0, device="cpu")
        assert _shapes(drawn) == want
        assert ("mtp" in drawn) == bool(lm["cfg"].mtp)
        assert drawn["blocks"]["ffn"]["router"].dtype == torch.float32

    def test_init_cache_layout(self, lm):
        want = _shapes(jax.tree.map(np.asarray, j_tf.init_cache(
            lm["jcfg"], 2, 16)))
        assert _shapes(t_tf.init_cache(lm["cfg"], 2, 16,
                                       device="cpu")) == want


class _Routes:
    """Records each route() call's experts on both sides, and can pin the
    port's to the reference's: the port's own probabilities of the
    reference's experts, renormalized (the aux loss is the port's)."""

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
        """Share of (token, k) decisions the two sides made alike (as
        sets), and whether every other one was a near-tie: the port's
        probability of the reference's expert within NEAR_TIE of its own
        k-th largest (relative)."""
        same = total = 0
        for want, (got, probs) in zip(self.ref, self.port):
            hit = (want[:, :, None] == got[:, None, :]).any(-1)
            same, total = same + int(hit.sum()), total + hit.size
            for t, i in zip(*np.nonzero(~hit)):
                kth = probs[t, got[t]].min()
                if (kth - probs[t, want[t, i]]) / kth > NEAR_TIE:
                    return same / total, False
        return same / total, True


# a routing difference between bf16 runs is a near-tie: the two experts'
# probabilities within 10 % (a router-logit gap of ~0.1, against the few
# bf16 ulps by which the two frameworks' hidden states differ); at most 5 %
# of decisions may differ
NEAR_TIE, ROUTE_AGREE = 0.1, 0.95


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_bf16_compute(name, monkeypatch):
    """The full configs' parameter and compute types at the reduced size
    (fp32 parameters for deepseek-v2-lite, bf16 for deepseek-v3; bf16
    compute): params_from_jax keeps bf16 leaves bf16 (the fp32 router
    too). The reference runs op by op, so its routing is seen: the port's
    agrees but for near-ties (the frameworks round bf16 at other points,
    and a near-tie then routes to the other expert, a whole expert's
    output apart). With the port's routing pinned to the reference's,
    prefill (both impls) and three decode steps lie within BF16_REL."""
    full = j_registry.get_config(name)
    jc = dataclasses.replace(j_registry.get_config(name, reduced=True),
                             dtype=full.dtype)
    tc = dataclasses.replace(t_registry.get_config(name, reduced=True),
                             dtype=t_base.DTypePolicy(**dataclasses.asdict(
                                 full.dtype)))
    jp = j_tf.init_params(jc, jax.random.PRNGKey(4))
    rng = np.random.default_rng(8)
    for stack in ("dense_blocks", "blocks"):
        for k in ("ln1", "ln2"):
            jp[stack][k] = jnp.asarray(
                1 + _normal(rng, jp[stack][k].shape, 0.1), jp[stack][k].dtype)
    params = t_tf.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    pdt = getattr(torch, full.dtype.param_dtype)
    assert params["blocks"]["ffn"]["w_gate"].dtype == pdt
    assert params["blocks"]["mixer"]["w_dkv"].dtype == pdt
    assert params["blocks"]["ffn"]["router"].dtype == torch.float32
    tokens = np.random.default_rng(6).integers(
        0, jc.vocab_size, (2, 12)).astype(np.int32)
    routes = _Routes(monkeypatch)
    with jax.disable_jit():
        want = np.asarray(j_tf.prefill(jc, jp, {"tokens": jnp.asarray(
            tokens)}))
        jcache, steps = j_tf.init_cache(jc, 2, 8), []
        for pos in range(3):
            lg, jcache = j_tf.decode_step(
                jc, jp, jcache, jnp.asarray(tokens[:, pos:pos + 1]), pos)
            steps.append(np.asarray(lg))
    ref_routes = list(routes.ref)
    n_moe = tc.n_layers - tc.moe.dense_first_k
    for impl in ("cuda", "torch"):
        routes.ref, routes.port = ref_routes[:n_moe], []
        t_tf.prefill(tc, params, {"tokens": tokens}, impl=impl)
        share, near_ties = routes.agreement()
        assert near_ties and share >= ROUTE_AGREE, (impl, share)
        routes.pin = list(ref_routes[:n_moe])
        got = t_tf.prefill(tc, params, {"tokens": tokens}, impl=impl)
        assert not routes.pin
        routes.pin = None
        assert _rel(got.numpy(), want) <= BF16_REL, impl
    routes.ref, routes.port = ref_routes[n_moe:], []
    routes.pin = list(ref_routes[n_moe:])
    tcache = t_tf.init_cache(tc, 2, 8, device="cpu")
    for pos in range(3):
        got, tcache = t_tf.decode_step(tc, params, tcache,
                                       tokens[:, pos:pos + 1], pos)
        assert _rel(got.numpy(), steps[pos]) <= BF16_REL
    assert not routes.pin
    routes.pin = None
    share, near_ties = routes.agreement()
    assert near_ties and share >= ROUTE_AGREE


@pytest.mark.parametrize("layout,k", [("every", 0), ("alternate", 0),
                                      ("dense_first_k", 2)])
def test_is_moe_layer(layout, k):
    jc = j_registry.get_config("deepseek-v2-lite-16b")
    tc = t_registry.get_config("deepseek-v2-lite-16b")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, layout=layout, dense_first_k=k))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, layout=layout, dense_first_k=k))
    for i in range(8):
        assert t_tf._is_moe_layer(tc, i) == j_tf._is_moe_layer(jc, i)
    assert not t_tf._is_moe_layer(t_registry.get_config("phi3-medium-14b"),
                                  3)
