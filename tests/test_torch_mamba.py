"""The Mamba-2 block of the PyTorch package (``models.mamba``) against the
reference on the CPU: the chunked SSD (output and final state, with and
without a carried-in state) against the reference's ``ssd_chunked`` and
against the port's step-by-step oracle, the decode step, the full block and
its one-token decode with the reference's parameters carried across, and
the block's init and cache layouts. Inputs come from numpy seeds and are
handed to both.

Tolerances: fp32 at tests/test_torch_lm.py's rtol 1e-4 with an absolute
1e-5 (1e-3 for decode) of the output's largest magnitude; the chunked and
the step-by-step forms of the recurrence sum in other orders and are held
at tests/test_model_components.py's 2e-4 (5e-4 for decode against the
full block). bf16 compute at ``BF16_REL`` = 5e-2 of the largest |output|
(XLA rounds its fused bf16 elementwise ops, SiLU among them, at other
points than torch: ROADMAP.md §3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SSMConfig as JSSM  # noqa: E402
from repro.models import mamba as j_mb  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSM  # noqa: E402
from repro_torch.models import mamba as t_mb  # noqa: E402

RTOL = 1e-4
DECODE_ATOL = 1e-3
BF16_REL = 5e-2
SSD_TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want, atol=1e-5, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _ssd_inputs(seed, b, S, H, P, N):
    """x, dt > 0, A < 0, B, C as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, S, H, N)).astype(np.float32)
    C = rng.standard_normal((b, S, H, N)).astype(np.float32)
    return x, dt, A, B, C


SSD_SHAPES = [(2, 16, 3, 8, 16, 4), (2, 64, 3, 8, 16, 16),
              (1, 64, 4, 16, 8, 64), (1, 96, 2, 4, 8, 32)]


class TestSSD:
    @pytest.mark.parametrize("with_h0", [False, True])
    @pytest.mark.parametrize("b,S,H,P,N,chunk", SSD_SHAPES)
    def test_chunked_matches_reference(self, b, S, H, P, N, chunk, with_h0):
        """Output and final state against the reference's ssd_chunked,
        with and without a carried-in state."""
        args = _ssd_inputs(S * H + chunk, b, S, H, P, N)
        h0 = (np.random.default_rng(1).standard_normal((b, H, P, N))
              .astype(np.float32) if with_h0 else None)
        y_j, st_j = j_mb.ssd_chunked(
            *(jnp.asarray(a) for a in args), chunk,
            None if h0 is None else jnp.asarray(h0))
        y_t, st_t = t_mb.ssd_chunked(*(_t(a) for a in args), chunk,
                                     None if h0 is None else _t(h0))
        assert y_t.dtype == torch.float32 and st_t.dtype == torch.float32
        assert tuple(st_t.shape) == (b, H, P, N)
        _close(y_t, y_j)
        _close(st_t, st_j)

    @pytest.mark.parametrize("b,S,H,P,N,chunk", SSD_SHAPES)
    def test_chunked_matches_the_recurrence(self, b, S, H, P, N, chunk):
        """Against the port's step-by-step oracle (y and final state) and
        the oracle against the reference's."""
        args = _ssd_inputs(S + chunk, b, S, H, P, N)
        y, st = t_mb.ssd_chunked(*(_t(a) for a in args), chunk)
        y_ref, st_ref = t_mb.ssd_reference(*(_t(a) for a in args),
                                           return_state=True)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **SSD_TOL)
        np.testing.assert_allclose(st.numpy(), st_ref.numpy(), **SSD_TOL)
        _close(y_ref, j_mb.ssd_reference(*(jnp.asarray(a) for a in args)))

    def test_cumsum_on_plain_tensors_is_torch_cumsum(self):
        """``models.common.cumsum``, which SSD's chunk sums go through, is
        ``torch.cumsum`` bitwise on plain tensors, forward and backward
        (its local-shard route is for DTensors only)."""
        from repro_torch.models.common import cumsum
        rng = np.random.default_rng(4)
        x = _t(rng.standard_normal((2, 3, 16, 4)).astype(np.float32))
        g = _t(rng.standard_normal((2, 3, 16, 4)).astype(np.float32))
        a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
        got, want = cumsum(a, 2), torch.cumsum(b, dim=2)
        assert torch.equal(got, want)
        got.backward(g)
        want.backward(g)
        assert torch.equal(a.grad, b.grad)

    def test_reference_in_float64(self):
        """The oracle computes in the type it is given (float64 for the
        card's check at the full layer shape) and returns x's type."""
        args = _ssd_inputs(7, 1, 32, 2, 4, 8)
        y32 = t_mb.ssd_reference(*(_t(a) for a in args))
        y64 = t_mb.ssd_reference(*(_t(a).double() for a in args),
                                 dtype=torch.float64)
        assert y32.dtype == torch.float32 and y64.dtype == torch.float64
        np.testing.assert_allclose(y32.numpy(), y64.numpy(), rtol=1e-5,
                                   atol=1e-5)
        y, _ = t_mb.ssd_chunked(*(_t(a).double() for a in args), 8)
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), y64.numpy(), **SSD_TOL)

    def test_carried_state_splits_the_sequence(self):
        """Two halves, the second started from the first's final state,
        equal the whole sequence."""
        x, dt, A, B, C = (_t(a) for a in _ssd_inputs(3, 2, 64, 3, 8, 16))
        y, st = t_mb.ssd_chunked(x, dt, A, B, C, 16)
        y1, st1 = t_mb.ssd_chunked(x[:, :32], dt[:, :32], A, B[:, :32],
                                   C[:, :32], 16)
        y2, st2 = t_mb.ssd_chunked(x[:, 32:], dt[:, 32:], A, B[:, 32:],
                                   C[:, 32:], 16, h0=st1)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                                   y.numpy(), **SSD_TOL)
        np.testing.assert_allclose(st2.numpy(), st.numpy(), **SSD_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_step_chained_matches_chunked(self, dtype):
        """ssd_step token by token: its outputs against ssd_chunked's and
        its state against the final state; each step against the
        reference's ssd_step."""
        x, dt, A, B, C = _ssd_inputs(4, 2, 32, 2, 4, 8)
        tdt = getattr(torch, dtype)
        xs = _t(x, tdt)
        y_c, st_c = t_mb.ssd_chunked(xs, _t(dt), _t(A), _t(B, tdt),
                                     _t(C, tdt), 8)
        st = torch.zeros(2, 2, 4, 8)
        jst = jnp.zeros((2, 2, 4, 8), jnp.float32)
        ys = []
        for t in range(32):
            st, y = t_mb.ssd_step(st, xs[:, t], _t(dt[:, t]), _t(A),
                                  _t(B[:, t], tdt), _t(C[:, t], tdt))
            jst, jy = j_mb.ssd_step(
                jst, jnp.asarray(x[:, t], dtype), jnp.asarray(dt[:, t]),
                jnp.asarray(A), jnp.asarray(B[:, t], dtype),
                jnp.asarray(C[:, t], dtype))
            assert y.dtype == tdt and st.dtype == torch.float32
            _close(st, jst)
            if dtype == "float32":
                _close(y, jy, atol=DECODE_ATOL)
            else:
                assert _rel(y, jy) <= BF16_REL
            ys.append(y)
        y_s = torch.stack(ys, 1)
        if dtype == "float32":
            np.testing.assert_allclose(y_s.numpy(), y_c.numpy(), **SSD_TOL)
            np.testing.assert_allclose(st.numpy(), st_c.numpy(), **SSD_TOL)
        else:
            assert y_c.dtype == torch.bfloat16
            assert _rel(y_s, y_c.float().numpy()) <= BF16_REL

    @pytest.mark.parametrize("S,chunk", [(10, 4), (10, 16), (64, 0)])
    def test_refuses_a_ragged_sequence(self, S, chunk):
        """S % chunk != 0 (S < chunk included) is refused, as the
        reference's reshape refuses it."""
        args = _ssd_inputs(5, 1, S, 2, 4, 3)
        if chunk:
            with pytest.raises(TypeError):
                j_mb.ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
        with pytest.raises(TypeError, match="multiple"):
            t_mb.ssd_chunked(*(_t(a) for a in args), chunk)


def _cfgs(**kw):
    base = dict(d_state=8, d_conv=4, expand=2, head_dim=8, chunk_size=8)
    base.update(kw)
    return JSSM(**base), TSSM(**base)


def _block_params(seed, d_model, ssm, around_one=False):
    """The reference's init_mamba drawn with a seed (numpy leaves); with
    ``around_one`` the constant leaves are moved off their init values so
    that every leaf reaches the output."""
    p = jax.tree.map(np.asarray, j_mb.init_mamba(
        jax.random.PRNGKey(seed), d_model, ssm))
    if around_one:
        rng = np.random.default_rng(seed)
        for k in ("conv_b", "dt_bias", "D", "norm"):
            p[k] = (p[k] + rng.standard_normal(p[k].shape) * 0.1).astype(
                np.float32)
    return p


BLOCK_CASES = {"seq16": (16, 2, 16, {}), "seq24_chunk8": (24, 2, 16, {}),
               "short": (5, 1, 16, {}),
               "groups2": (16, 2, 32, dict(ngroups=2)),
               "chunk_over_seq": (12, 2, 16, dict(chunk_size=32))}


class TestBlock:
    @pytest.mark.parametrize("case", sorted(BLOCK_CASES))
    def test_block_matches_reference(self, case):
        """mamba_block with the reference's parameters; S < chunk runs at
        chunk = S as the reference's ``min(chunk_size, S)``."""
        S, b, d_model, kw = BLOCK_CASES[case]
        jssm, tssm = _cfgs(**kw)
        p = _block_params(3, d_model, jssm, around_one=True)
        x = np.random.default_rng(4).standard_normal(
            (b, S, d_model)).astype(np.float32)
        want = j_mb.mamba_block(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), d_model, jssm)
        got = t_mb.mamba_block({k: _t(v) for k, v in p.items()}, _t(x),
                               d_model, tssm)
        assert got.dtype == torch.float32
        _close(got, want)

    def test_block_bf16(self):
        """bf16 parameters and input, as a layer after the per-layer cast."""
        jssm, tssm = _cfgs()
        p = _block_params(5, 16, jssm, around_one=True)
        x = np.random.default_rng(6).standard_normal((2, 16, 16)).astype(
            np.float32)
        want = j_mb.mamba_block(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p),
            jnp.asarray(x, jnp.bfloat16), 16, jssm)
        got = t_mb.mamba_block({k: _t(v, torch.bfloat16)
                                for k, v in p.items()},
                               _t(x, torch.bfloat16), 16, tssm)
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= BF16_REL

    @pytest.mark.parametrize("ngroups", [1, 2])
    def test_bc_heads(self, ngroups):
        jssm, tssm = _cfgs(ngroups=ngroups)
        t = np.arange(2 * 3 * ngroups * 8, dtype=np.float32).reshape(
            2, 3, ngroups * 8)
        want = j_mb._bc_heads(jnp.asarray(t), 2, 3, 4, jssm)
        assert np.array_equal(t_mb._bc_heads(_t(t), 2, 3, 4, tssm).numpy(),
                              np.asarray(want))

    @pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
    def test_decode_matches_reference(self, conv_dtype):
        """Five one-token steps with the reference's parameters; the conv
        window in fp32 or in the model cache's bf16."""
        jssm, tssm = _cfgs()
        p = _block_params(7, 16, jssm, around_one=True)
        jp = jax.tree.map(jnp.asarray, p)
        tp = {k: _t(v) for k, v in p.items()}
        jc = j_mb.init_mamba_cache(16, jssm, 2)
        tc = t_mb.init_mamba_cache(16, tssm, 2)
        xs = np.random.default_rng(8).standard_normal((2, 5, 16)).astype(
            np.float32)
        for t in range(5):
            want, jc = j_mb.mamba_decode(jp, jnp.asarray(xs[:, t:t + 1]),
                                         jc, 16, jssm)
            got, tc = t_mb.mamba_decode(tp, _t(xs[:, t:t + 1]), tc, 16, tssm)
            assert tuple(got.shape) == (2, 1, 16)
            _close(got, want, atol=DECODE_ATOL)
            _close(tc["ssm"], jc["ssm"])
            assert tc["conv"].dtype == torch.float32
            if conv_dtype == "bfloat16":
                jc = dict(jc, conv=jc["conv"].astype(jnp.bfloat16))
                tc = dict(tc, conv=tc["conv"].to(torch.bfloat16))
            _close(tc["conv"], jc["conv"])

    def test_decode_bf16(self):
        """bf16 parameters and input, the conv window promoted to fp32 and
        cast back (the reference promotes; torch is told)."""
        jssm, tssm = _cfgs()
        p = _block_params(9, 16, jssm, around_one=True)
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
        tp = {k: _t(v, torch.bfloat16) for k, v in p.items()}
        jc = j_mb.init_mamba_cache(16, jssm, 2)
        tc = t_mb.init_mamba_cache(16, tssm, 2)
        xs = np.random.default_rng(10).standard_normal((2, 4, 16)).astype(
            np.float32)
        for t in range(4):
            want, jc = j_mb.mamba_decode(
                jp, jnp.asarray(xs[:, t:t + 1], jnp.bfloat16), jc, 16, jssm)
            got, tc = t_mb.mamba_decode(tp, _t(xs[:, t:t + 1],
                                               torch.bfloat16), tc, 16, tssm)
            assert got.dtype == torch.bfloat16
            assert tc["conv"].dtype == torch.float32
            assert _rel(got, want) <= BF16_REL

    @pytest.mark.parametrize("seq,chunk", [(16, 8), (24, 8), (7, 8)])
    def test_decode_matches_full(self, seq, chunk):
        """Token by token through mamba_decode == the full-sequence block
        (tests/test_model_components.py's tolerance)."""
        _, tssm = _cfgs(chunk_size=chunk)
        jssm, _ = _cfgs(chunk_size=chunk)
        p = {k: _t(v) for k, v in _block_params(
            3, 16, jssm, around_one=True).items()}
        x = _t(np.random.default_rng(4).standard_normal(
            (2, seq, 16)).astype(np.float32))
        full = t_mb.mamba_block(p, x, 16, tssm)
        cache, ys = t_mb.init_mamba_cache(16, tssm, 2), []
        for t in range(seq):
            y, cache = t_mb.mamba_decode(p, x[:, t:t + 1], cache, 16, tssm)
            ys.append(y)
        np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                                   rtol=5e-4, atol=5e-4)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


class TestLayout:
    @pytest.mark.parametrize("d_model,kw", [(64, {}),
                                            (32, dict(ngroups=2,
                                                      head_dim=16))])
    def test_dims(self, d_model, kw):
        jssm, tssm = _cfgs(**kw)
        assert t_mb.dims(d_model, tssm) == j_mb.dims(d_model, jssm)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_init_matches_reference_layout(self, dtype):
        """init_mamba draws the reference's leaves (stacked over n layers)
        in the given type, with the reference's constants."""
        jssm, tssm = _cfgs()
        want = _shapes(jax.tree.map(np.asarray, j_mb.init_mamba(
            jax.random.PRNGKey(0), 16, jssm, getattr(jnp, dtype))))
        gen = torch.Generator().manual_seed(0)
        got = t_mb.init_mamba(gen, 3, 16, tssm, getattr(torch, dtype))
        assert _shapes({k: v[0] for k, v in got.items()}) == want
        assert all(v.shape[0] == 3 for v in got.values())
        ref = j_mb.init_mamba(jax.random.PRNGKey(0), 16, jssm)
        for k in ("conv_b", "dt_bias", "A_log", "D", "norm"):
            np.testing.assert_allclose(got[k][2].float().numpy(),
                                       np.asarray(ref[k], np.float32),
                                       rtol=1e-2 if dtype == "bfloat16"
                                       else 1e-6, atol=1e-7)
        assert 0.08 < float(got["conv_w"].float().std()) < 0.12

    def test_cache_layout(self):
        jssm, tssm = _cfgs()
        want = _shapes(jax.tree.map(np.asarray,
                                    j_mb.init_mamba_cache(16, jssm, 3)))
        assert _shapes(t_mb.init_mamba_cache(16, tssm, 3)) == want
