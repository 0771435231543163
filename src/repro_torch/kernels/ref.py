"""The plain PyTorch versions of every kernel, under the names of the
reference's ``repro.kernels.ref`` oracles. Each lives beside its kernel
wrapper; this module collects them, with the distance in bf16 ulps that
holds a kernel's bf16 output to its plain version's fp32 result."""
from repro_torch.kernels.flash_attention import BIAS_ULP, bf16_ulp
from repro_torch.kernels.fused_gnn import fused_gnn_layer_ref
from repro_torch.kernels.gat_attention import gat_attention_ref
from repro_torch.kernels.scatter_gather import scatter_gather_aggregate_ref

__all__ = ["fused_gnn_layer_ref", "scatter_gather_aggregate_ref",
           "gat_attention_ref", "bf16_ulps", "bf16_reading",
           "bf16_bias_ulp"]


def bf16_ulps(got, want):
    """Per element, how many bfloat16 values lie between ``got`` and
    ``want``, each rounded to bfloat16 (0: the same value; 1: neighbours).
    NaN against NaN counts 0, NaN against a number 2**30."""
    import torch

    def key(t):                       # bf16 bits as an ordered integer
        k = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)

    d = (key(got) - key(want)).abs()
    ng, nw = torch.isnan(got), torch.isnan(want)
    d = torch.where(ng & nw, torch.zeros_like(d), d)
    return torch.where(ng ^ nw, torch.full_like(d, 1 << 30), d)


# A bf16 kernel output against its plain version's fp32 result. Both sum in
# fp32, in different orders, so they agree to the fp32 kernels' 2e-5 before
# rounding; near 0 that is several bf16 ulps, so elements whose error is
# within it are not counted in ulps. Everything stays within the
# reference's bf16 tolerance (tests/test_kernels.py: rtol = atol = 2e-2).
BF16_FP32_ATOL = 2e-5
BF16_REF_TOL = 2e-2


def bf16_reading(got, want):
    """(ok, the largest ulp distance where |got - want| > 2e-5, the largest
    |got - want|): ``got`` (bf16) within one bf16 ulp of ``want`` (fp32)
    rounded to bf16 outside that floor, NaN in the same places, and all of
    it within rtol = atol = 2e-2."""
    import torch

    g, w = got.float(), want.float()
    ulps = bf16_ulps(g, w)
    diff = (g - w).abs()
    counted = ~(diff <= BF16_FP32_ATOL) & ~(torch.isnan(g) & torch.isnan(w))
    worst = int(ulps[counted].max()) if bool(counted.any()) else 0
    fin = torch.isfinite(w)
    err = float(diff[fin].max()) if bool(fin.any()) else 0.0
    ok = worst <= 1 and bool(torch.allclose(
        g, w, rtol=BF16_REF_TOL, atol=BF16_REF_TOL, equal_nan=True))
    return ok, worst, err


BF16_BIAS_ULP = BIAS_ULP    # largest |mean signed error| in ulps


def bf16_bias_ulp(got, want):
    """The mean signed error ``sign(want) (got - want)`` over the elements
    finite in both where ``want`` is not 0 (a zero has no side to round
    towards; a GNN layer's ReLU and row mask make many), in units of their
    mean bf16 ulp (``flash_attention``'s check (b)): near 0 for a store
    that rounds to nearest, about -0.5 for one that truncates, which
    ``bf16_reading``'s one ulp lets through."""
    import torch

    g, w = got.float(), want.float()
    keep = torch.isfinite(g) & torch.isfinite(w) & (w != 0)
    g, w = g[keep], w[keep]
    if w.numel() == 0:
        return 0.0
    return float((torch.sign(w) * (g - w)).sum() / bf16_ulp(w).sum())
