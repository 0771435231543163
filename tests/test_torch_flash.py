"""``flash_attention``'s two CUDA kernels, checked on the CPU where they
cannot run: the choice between them (by dtype, q/k width and v width), the
tolerance and checks that hold the wgmma kernel (which rounds P to bf16
before P.V), v narrower than q and k (MLA's core) against the
padded-then-sliced call, the cost model with v at its own width, grouped
KV heads read in place against the reference's Pallas kernel (interpret
mode) on K/V repeated by numpy, and the build hash over included headers. The kernels
themselves are held to these checks on a card (tests/test_torch_gpu.py,
chip_smoke.py).

The wgmma kernel's arithmetic is emulated in plain PyTorch: fp32 scores
and unnormalized probabilities p, p rounded to bf16, ``(p @ v) / l`` in
fp32, the output rounded to the nearest bf16 (or, for the planted faults,
otherwise)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as j_flash  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402


def _inputs(seed, b, h, kh, sq, sk, d, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)) * scale
    k, v = (rng.standard_normal((b, kh, sk, d)) for _ in range(2))
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for a in (q, k, v)]


def _ref(q, k, v, causal):
    p, den, vf = t_flash._parts(q, k, v, causal)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).div_(den)


def _emulate(q, k, v, causal, p_scale=1.0, store="rn"):
    """The wgmma kernel's arithmetic: p rounded to bf16 for P.V, l summed
    from the unrounded p, the quotient stored rounded to nearest ("rn") or
    toward zero ("rz")."""
    p, den, vf = t_flash._parts(q, k, v, causal)
    p_bf16 = (p * p_scale).to(torch.bfloat16).float()
    out = torch.einsum("bhqk,bhkd->bhqd", p_bf16, vf).div_(den)
    if store == "rz":
        bits = out.view(torch.int32) & ~0xFFFF
        return bits.view(torch.float32).to(torch.bfloat16)
    return out.to(torch.bfloat16)


SHAPES = [  # b, h, kh, sq, sk, d, causal, score scale
    (1, 2, 2, 256, 256, 128, True, 1.0),
    (1, 4, 1, 300, 300, 64, True, 1.0),
    (2, 4, 2, 200, 130, 128, False, 1.0),
    (1, 2, 1, 256, 256, 64, True, 4.0),     # peaked softmax
    (1, 2, 2, 128, 300, 128, False, 0.1),   # nearly uniform
]


class TestBf16Check:
    @pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,scale", SHAPES)
    def test_tolerance_bounds_p_rounded_to_bf16(self, b, h, kh, sq, sk, d,
                                                causal, scale):
        q, k, v = _inputs(sq + d, b, h, kh, sq, sk, d, scale)
        out = _emulate(q, k, v, causal)
        r = t_flash.flash_bf16_check(out, out.clone(), _ref(q, k, v, causal),
                                     t_flash.flash_bf16_tol(q, k, v,
                                                            causal=causal))
        assert r["ok"], r
        assert r["worst"] <= 0.75 and abs(r["bias_ulp"]) <= 0.05

    @pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,scale", SHAPES[:3])
    def test_p_scaled_by_0_99_fails(self, b, h, kh, sq, sk, d, causal,
                                    scale):
        """A uniform 1 % cut of p moves each output by 1 % of |ref|, which
        stays inside 2^-7 (A + |ref|) because |ref| <= A: check (a) cannot
        see it. Check (b) does: about -1.8 ulp on average."""
        q, k, v = _inputs(sq + d, b, h, kh, sq, sk, d, scale)
        out = _emulate(q, k, v, causal, p_scale=0.99)
        r = t_flash.flash_bf16_check(out, out.clone(), _ref(q, k, v, causal),
                                     t_flash.flash_bf16_tol(q, k, v,
                                                            causal=causal))
        assert not r["ok"]
        assert r["worst"] <= 1.0 and r["bias_ulp"] < -1.0

    def test_truncating_store_fails_on_its_bias(self):
        q, k, v = _inputs(1, 1, 4, 2, 256, 256, 128)
        out = _emulate(q, k, v, True, store="rz")
        r = t_flash.flash_bf16_check(out, out.clone(), _ref(q, k, v, True),
                                     t_flash.flash_bf16_tol(q, k, v))
        assert not r["ok"]
        assert r["worst"] <= 1.0 and -0.6 < r["bias_ulp"] < -0.4

    def test_a_launch_that_differs_fails(self):
        q, k, v = _inputs(2, 1, 2, 2, 128, 128, 64)
        out = _emulate(q, k, v, True)
        again = out.clone()
        bits = again.view(-1).view(torch.int16)
        bits[1000] ^= 1                     # one ulp in one element
        r = t_flash.flash_bf16_check(out, again, _ref(q, k, v, True),
                                     t_flash.flash_bf16_tol(q, k, v))
        assert not r["repeatable"] and not r["ok"]

    def test_bf16_ulp(self):
        x = torch.tensor([1.0, 1.5, -2.0, 0.75, 3e-3])
        want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 2.0 ** -8,
                             2.0 ** -16])
        assert torch.equal(t_flash.bf16_ulp(x), want)


class TestVariant:
    @pytest.mark.parametrize("dtype,d,want", [
        (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 32, "cuda_core"), (torch.bfloat16, 96, "cuda_core"),
        (torch.bfloat16, 256, "cuda_core"), (torch.float32, 64, "cuda_core"),
        (torch.float32, 128, "cuda_core"), (torch.float32, 16, "cuda_core")])
    def test_choice(self, dtype, d, want):
        assert t_flash.flash_variant(dtype, d) == want

    @pytest.mark.parametrize("name", [
        n for n in registry.ARCHS
        if registry.get_config(n).family in ("dense", "hybrid", "audio",
                                             "vlm")])
    def test_every_attention_config_serves_on_the_wgmma_kernel(self, name):
        cfg = registry.get_config(name)
        assert cfg.dtype.compute_dtype == "bfloat16"
        assert t_flash.flash_variant(torch.bfloat16,
                                     cfg.resolved_head_dim) == "wgmma"

    @pytest.mark.parametrize("dtype,d,dv,want", [
        (torch.bfloat16, 192, 128, "wgmma"),
        (torch.bfloat16, 192, None, "cuda_core"),
        (torch.bfloat16, 192, 192, "cuda_core"),
        (torch.bfloat16, 64, 64, "wgmma"), (torch.bfloat16, 128, None, "wgmma"),
        (torch.bfloat16, 128, 64, "cuda_core"),
        (torch.float32, 192, 128, "cuda_core")])
    def test_choice_by_v_width(self, dtype, d, dv, want):
        """(q/k width, v width): the wgmma kernel takes (64, 64),
        (128, 128) and MLA's (192, 128); (192, 192) does not fit its
        shared memory; v_dim=None is v as wide as q."""
        assert t_flash.flash_variant(dtype, d, dv) == want

    @pytest.mark.parametrize("name", [
        n for n in registry.ARCHS if registry.get_config(n).mla is not None])
    def test_every_mla_config_serves_on_the_wgmma_kernel(self, name):
        a = registry.get_config(name).mla
        assert t_flash.flash_variant(
            torch.bfloat16, a.qk_nope_head_dim + a.qk_rope_head_dim,
            a.v_head_dim) == "wgmma"

    def test_reset_zeroes_each_kernels_count(self, monkeypatch):
        monkeypatch.setattr(t_flash, "variant_launches",
                            {"wgmma": 3, "cuda_core": 2})
        monkeypatch.setattr(t_flash, "launches", 5)
        ops.reset_launch_counts()
        assert t_flash.variant_launches == {"wgmma": 0, "cuda_core": 0}
        assert ops.launch_counts()["flash_attention"] == 0


class TestGroupedKV:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("kh", [1, 2])
    def test_matches_reference_kernel_on_repeated_kv(self, kh, causal):
        """k/v with Kh of 4 heads through the port against the Pallas
        kernel (interpret mode) on K/V repeated 4 // Kh times by numpy."""
        rng = np.random.default_rng(kh)
        q = rng.standard_normal((2, 4, 64, 32)).astype(np.float32)
        k, v = (rng.standard_normal((2, kh, 96, 32)).astype(np.float32)
                for _ in range(2))
        want = j_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(np.repeat(k, 4 // kh, axis=1)),
            jnp.asarray(np.repeat(v, 4 // kh, axis=1)), causal=causal,
            block_q=32, block_k=32, interpret=True)
        got = t_flash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)

    def test_rejects_heads_that_do_not_group(self):
        q = torch.zeros(1, 4, 8, 16)
        with pytest.raises(ValueError, match="H % Kh"):
            t_flash.flash_attention(q, torch.zeros(1, 3, 8, 16),
                                    torch.zeros(1, 3, 8, 16))

    def test_attention_hands_the_kernel_its_kv_heads(self, monkeypatch):
        """``_flash_core`` passes k/v with their own Kh heads (no copies
        per query head) and gets the repeated-heads answer."""
        seen = []

        def spy(q, k, v, *, causal):
            seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
            return t_flash.flash_attention(q, k, v, causal=causal)

        monkeypatch.setattr(t_attn, "flash_attention", spy)
        rng = np.random.default_rng(5)
        q = torch.from_numpy(rng.standard_normal((1, 40, 8, 16))
                             .astype(np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 16))
                                 .astype(np.float32)) for _ in range(2))
        got = t_attn._flash_core(q, k, v, True)
        assert seen == [((1, 8, 40, 16), (1, 2, 40, 16), (1, 2, 40, 16))]
        want = t_flash.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(4, 1),
            v.transpose(1, 2).repeat_interleave(4, 1)).transpose(1, 2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


class TestNarrowV:
    """v narrower than q and k (Dv < D, MLA's core): the plain version
    computes at v's width what the padded-then-sliced call computes."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("kh", [1, 2])
    def test_ref_equals_padded_then_sliced(self, kh, causal):
        rng = np.random.default_rng(10 + kh)
        q = torch.from_numpy(rng.standard_normal((2, 2, 40, 24))
                             .astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((2, kh, 56, 24))
                             .astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((2, kh, 56, 16))
                             .astype(np.float32))
        vp = torch.nn.functional.pad(v, (0, 8))
        got = t_flash.flash_attention_ref(q, k, v, causal=causal)
        want = t_flash.flash_attention_ref(q, k, vp, causal=causal)
        assert tuple(got.shape) == (2, 2, 40, 16)
        torch.testing.assert_close(got, want[..., :16], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(
            t_flash.flash_bf16_tol(q, k, v, causal=causal),
            t_flash.flash_bf16_tol(q, k, vp, causal=causal)[..., :16],
            rtol=1e-6, atol=1e-6)
        # the wrapper on the CPU: the plain version at v's width
        assert torch.equal(t_flash.flash_attention(q, k, v, causal=causal),
                           got)

    @pytest.mark.parametrize("causal", [True, False])
    def test_emulated_wgmma_at_d192_v128_passes_the_check(self, causal):
        """The wgmma kernel's arithmetic at MLA's widths (q/k 192, v 128)
        is held by flash_bf16_check at v's width."""
        rng = np.random.default_rng(19)
        q, k = (torch.from_numpy(rng.standard_normal((1, 2, 130, 192))
                                 .astype(np.float32)).to(torch.bfloat16)
                for _ in range(2))
        v = torch.from_numpy(rng.standard_normal((1, 2, 130, 128))
                             .astype(np.float32)).to(torch.bfloat16)
        out = _emulate(q, k, v, causal)
        assert tuple(out.shape) == (1, 2, 130, 128)
        r = t_flash.flash_bf16_check(out, out.clone(), _ref(q, k, v, causal),
                                     t_flash.flash_bf16_tol(q, k, v,
                                                            causal=causal))
        assert r["ok"], r

    def test_refuses_v_wider_than_q(self):
        q = torch.zeros(1, 2, 8, 16)
        with pytest.raises(ValueError, match="Dv <= D"):
            t_flash.flash_attention(q, q, torch.zeros(1, 2, 8, 32))
        with pytest.raises(ValueError, match="do not match"):
            t_flash.flash_attention(q, q, torch.zeros(1, 2, 9, 8))

    @pytest.mark.parametrize("args", [(1, 16, 8192, 8192, 192, True, 2, 128),
                                      (2, 4, 64, 128, 32, False, 4, 16),
                                      (1, 2, 64, 64, 16, True, 4, 16)])
    def test_flash_cost_counts_v_at_its_width(self, args):
        """With v_dim: Q.K^T at D and P.V at v_dim, 2·B·H·Sq·Sk·(D + Dv)
        operations (halved when causal and square), and q, k, v and the
        output each moved once at their own widths; at v_dim = D the
        reference's model."""
        B, H, Sq, Sk, D, causal, bp, dv = args
        frac = 0.5 if causal and Sq == Sk else 1.0
        c = t_flash.flash_cost(B, H, Sq, Sk, D, causal, bp, v_dim=dv)
        assert c["flops"] == 2.0 * B * H * Sq * Sk * (D + dv) * frac
        assert c["hbm_bytes"] == bp * B * H * (Sq * D + Sk * D + Sk * dv
                                               + Sq * dv)
        assert t_flash.flash_cost(B, H, Sq, Sk, D, causal, bp, v_dim=D) == \
            j_flash.flash_cost(B, H, Sq, Sk, D, causal, bp)


class TestBuildHash:
    def test_covers_the_headers_a_kernel_includes(self, tmp_path,
                                                  monkeypatch):
        monkeypatch.setattr(build, "CSRC", tmp_path)
        (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <x.h>\n')
        (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
        (tmp_path / "b.cuh").write_text("// b\n")
        (tmp_path / "other.cuh").write_text("// unrelated\n")
        assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh",
                                                        "b.cuh"]
        first = build.library_path("k")
        (tmp_path / "other.cuh").write_text("// changed\n")
        assert build.library_path("k") == first
        (tmp_path / "b.cuh").write_text("// b, changed\n")
        assert build.library_path("k") != first

    def test_flash_attention_includes_the_hopper_header(self):
        names = [p.name for p in build.sources("flash_attention")]
        assert names == ["flash_attention.cu", "hopper.cuh"]
