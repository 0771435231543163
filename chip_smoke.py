#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Environment: requires a CUDA device; prints the card's name and power
   limit, the torch and CUDA versions, and turns TF32 off.
2. Builds every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc each,
   in parallel) and prints the build time and ptxas' register report.
3. Holds each GNN kernel against its plain PyTorch version on the card, at
   the serving path's shapes (C=64, N=256, Fin=512 for layer 0 and 256
   inner, Fout=256, 4 heads, E = the engine's edge budget) with inputs from
   a real batch of the Flickr-sized graph, and on the edge cases of the CPU
   tests (unaligned f_in=500 in all three forms, block_f invariance, 64
   edges into one vertex, GAT rows that are empty, dense, or whose scores
   are all -inf, rows summing to one). Tolerance: rtol = atol = 2e-5
   (fp32, as tests/test_kernels.py). ``fused_gnn_layer``: its four serving
   rows and the self-only Transform (Fin 256), each launched twice (bitwise
   equal, both on the tf32x3 kernel). ``scatter_gather_aggregate``: F 512
   and 256 (bitwise equal over two launches), and inf and NaN on the source
   row of the weight-0 padding edges: NaN exactly where the plain version
   puts it (the oracle's 0 * h[src]), the rest within the tolerance.
   ``gat_attention``: the real structure at 4, 1, 2 and 8 heads (head
   widths 64, 256, 128, 32), N=200 on the slab kernel and N=320 on the row
   kernel, each launched twice (bitwise equal, on the kernel named), and
   inf and NaN in z behind a weight of 0 (outside the structure, or a
   structural exp that underflows) and behind a subnormal weight: NaN
   exactly where the plain version puts it (the oracle's attn @ z). The
   checks are lists (``fused_checks``, ``sg_checks``, ``gat_checks``) that
   scripts/gnn_fault_check.py runs on planted faults. Times each kernel,
   its plain version and the one PyTorch library call that computes the
   same function (CUDA events, mean of many launches after warm-up)
   beside the least time the card could take (bytes over 3.35 TB/s or
   operations over the peak for their type, whichever is larger: 67
   TFLOP/s fp32, 989 TFLOP/s bf16; the fused layer's three tf32 products
   of each multiply-add at 494.7 TFLOP/s), and requires the fused layer at
   Fin=512 to be no slower than the ``baddbmm`` chain.
4. Holds ``flash_attention``'s two kernels against their plain version.
   The CUDA-core kernel (fp32, and bf16 at a head dim the wgmma kernel does
   not take): fp32 at rtol = atol = 2e-5 on the shapes of
   tests/test_kernels.py (causal and not, Sq != Sk), on ragged S=1000 at
   D=64 and 128 and with grouped KV heads; bf16 at D=32 to one bf16 ulp
   with at least 99 % of the outputs bitwise equal. The wgmma kernel (bf16,
   D=64 and 128) on small, ragged, non-causal and grouped shapes and at
   the prefill's shape (B=1, H=40, 10 KV heads, S=8192, D=128, causal):
   ``flash_bf16_check`` (every element within ``flash_bf16_tol``, the mean
   signed error within 0.1 bf16 ulp, two launches bitwise equal; planted
   faults in the kernel fail it: scripts/flash_fault_check.py). Times the
   kernel, its plain version and ``scaled_dot_product_attention(
   is_causal=True, enable_gqa=True)`` (timed only; the package never
   calls it) there, and the kernel once more with K/V repeated to 40 heads.
5. Drives ``DecoupledEngine.infer`` for GCN, GraphSAGE and GAT at the
   paper's width (L=5, N=256, f_hidden=256, 4 heads, C=64, impl="cuda") in
   forced dense and forced sg mode on Zipf traffic, with random weights from
   a seed; the kernels' launch counts are zeroed before and read after, and
   each must match the program's count per batch; every ``fused_gnn_layer``
   launch must be the tf32x3 kernel and every ``gat_attention`` launch the
   slab kernel. Each engine's embeddings are compared with an impl="torch"
   engine on the same card and params (rtol 1e-4, atol 1e-5). Then one
   traced device step (``run_device``: the copy and the program) of a
   gat/dense and a gcn/sg batch: device time by kernel and copy, and the
   card's busy share (``torch.profiler``).
6. LM serving: phi3-medium-14b at full width (d_model 5120, 40 heads, 10 KV
   heads, d_ff 17920, vocab 100352, fp32 params, bf16 compute), depth cut
   to 8 layers, random weights from seed 0, one prompt of 8192 tokens from
   ``numpy.random.default_rng(0)``. ``prefill(impl="cuda")`` must launch
   ``flash_attention`` exactly once a layer, every launch the wgmma kernel,
   and no other kernel; its logits
   are held against ``prefill(impl="torch")`` on the same card and params,
   and 16 ``decode_step``s from an empty cache against the prefill of the
   same 16 tokens (tolerances at ``LM_TOL`` and ``DECODE_TOL``, with their
   reasons). Prints latency, tokens/s and peak device memory on ``[lm]``
   lines, and the device time by kernel from ``torch.profiler``.
7. The scatter-gather's bucket kernel (32-bit edge indices, scratch in
   device memory) against its plain version at ``KERNEL_TOL``: on a real
   forced-sg batch of the Flickr-sized graph at N=1024 (74,496 edge
   slots, C cut to 8, F=256), NaN in the same places on the weight-0
   probe, and on the serving batch's edge lists padded to E = 65,537. The
   three GNN kernels in bf16 at the serving shapes (fused: cuda_core; GAT:
   row; sg: sort, and bucket at N=1024), each within one bf16 ulp of its
   plain version's fp32 result rounded to bf16 (``bf16_reading``) and
   within the reference's 2e-2; each timed beside its bound, plain and
   library times. The [engine] phase's 50 sg launches must all be on the
   sort kernel.
8. ``[serve]``: one ``GNNServer`` on the Flickr-sized graph registers GCN
   (mode sg), GraphSAGE (dense, resident feature store) and GAT (dense)
   at the [engine] phase's width and depth under one H100 DSE plan, and
   answers 3 x 192 Zipf(1.1) requests; every embedding is held to the same
   engine's ``infer`` (``ENGINE_TOL``), the launch counts (zeroed just
   before) to the lanes' batches, every launch on the serving kernels
   (tf32x3, sort, slab); a GAT at N=8192 raises PlanViolation at
   register. Prints the plan, each lane's p50/p90/p99 and overlap, and the
   bytes the resident lane ships against a dense lane.
9. ``[repeat]``: two device steps of one gat/sg and one gcn/sg batch under
   impl="torch" and impl="cuda": bitwise equal or not, and the largest
   difference (the plain sg paths sum with ``index_add_``).
10. Prints the ``kernels`` JSON line (each kernel with its ``variants``:
   the bucket scatter-gather and the bf16 kernels) and, last, the ``ok``
   line.

Any failure exits nonzero before the last line.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.dse import (H100Spec, PlanViolation,  # noqa: E402
                                  plan_covers)
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.gnn.layers import dense_init  # noqa: E402
from repro_torch.gnn.model import GNNConfig, init_gnn  # noqa: E402
from repro_torch.graphs.synthetic import get_graph, zipf_traffic  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernels  # noqa: E402
from repro_torch.kernels import fused_gnn as fused_kernels  # noqa: E402
from repro_torch.kernels import gat_attention as gat_kernels  # noqa: E402
from repro_torch.kernels import scatter_gather as sg_kernels  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref, flash_bf16_check, flash_bf16_tol,
    flash_cost, flash_variant)
from repro_torch.kernels.fused_gnn import (ACTS,  # noqa: E402
                                           fused_gnn_layer,
                                           fused_gnn_layer_ref)
from repro_torch.kernels.gat_attention import (  # noqa: E402
    gat_attention, gat_attention_ref, gat_variant)
from repro_torch.kernels.ref import bf16_reading  # noqa: E402
from repro_torch.kernels.scatter_gather import (  # noqa: E402
    scatter_gather_aggregate, scatter_gather_aggregate_ref, sg_variant)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.serve.gnn_server import GNNServer  # noqa: E402
from repro_torch.store import StorePolicy  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
PEAK_TF32_FLOPS = 494.7e12       # H100 SXM tf32 tensor cores, dense
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
# flash_attention's CUDA-core kernel in bf16: it and its plain version both
# compute in fp32 from the same bf16 inputs (agreeing to KERNEL_TOL) and
# round once on the store, so they may land on neighbouring bf16 values: one
# ulp, at most 2^-7 of the value. Most elements round alike; a truncating
# store would not. (The wgmma kernel rounds P to bf16 before P.V: it is held
# by flash_bf16_check instead.)
FLASH_BF16_TOL = dict(rtol=2.0 ** -7, atol=2e-5)
FLASH_BF16_EQUAL = 0.99
ENGINE_TOL = dict(rtol=1e-4, atol=1e-5)
C, N, F_IN, F_HID, HEADS, LAYERS = 64, 256, 500, 256, 4, 5
N_BATCHES = 4                    # measured batches per engine (+1 warm-up)
# the scatter-gather's bucket kernel on a real forced-sg batch of the
# Flickr-sized graph at N=1024 (its edge budget: 74,496 slots); C cut from
# 64 to 8 (a host Build of 64 subgraphs at N=1024 would take tens of
# seconds), and on the serving batch's edge lists padded past the sort
# kernel's 16-bit indices to 65,537 slots
BIG_N, BIG_C, WIDE_E = 1024, 8, 65537
# [serve]: requests a lane (3 batches of C), and GCN, GraphSAGE and GAT
# at the [engine] phase's width and depth, each lane's mode fixed so that
# all three GNN kernels run on the server path
SERVE_REQUESTS = 3 * C
SERVE_LANES = {"gcn": dict(mode="sg"),
               "sage": dict(mode="dense", features="resident"),
               "gat": dict(mode="dense")}
# LM phase: phi3-medium-14b at full width, depth cut to 8 of its 40 layers
# (the fp32 parameters of 40 layers, 58.6 GB, and the plain path's 27 GB of
# transient scores do not fit one 80 GB card together)
LM_ARCH, LM_LAYERS, LM_SEQ, LM_DECODE = "phi3-medium-14b", 8, 8192, 16
# impl="cuda" against impl="torch" (and decode against prefill) in bf16:
# the paths round at different points (the kernel rounds the unnormalized
# probabilities to bf16 before P.V, the plain path the normalized ones, as
# JAX does; decode runs other matmul shapes), and every bf16 op after that
# rounds the residual stream again, 8 layers deep. Held: max |diff| over
# max |logit|, and the share of positions whose top-1 token agrees.
LM_TOL = dict(rel=5e-2, top1=0.9)
DECODE_TOL = dict(rel=5e-2, top1=0.875)
# kernel launches per batch at L=5 (the program's count, see README)
EXPECTED = {
    ("gcn", "dense"): {"fused_gnn_layer": 5},
    ("sage", "dense"): {"fused_gnn_layer": 5},
    ("gat", "dense"): {"fused_gnn_layer": 5, "gat_attention": 5},
    ("gcn", "sg"): {"fused_gnn_layer": 5, "scatter_gather_aggregate": 5},
    ("sage", "sg"): {"scatter_gather_aggregate": 5},
    ("gat", "sg"): {"fused_gnn_layer": 5},
}
REPLACES = {
    "fused_gnn_layer": ("src/repro_torch/csrc/fused_gnn.cu",
                        "src/repro/kernels/fused_gnn.py:65"),
    "scatter_gather_aggregate": ("src/repro_torch/csrc/scatter_gather.cu",
                                 "src/repro/kernels/scatter_gather.py:67"),
    "gat_attention": ("src/repro_torch/csrc/gat_attention.cu",
                      "src/repro/kernels/gat_attention.py:53"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:79"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, flops: float, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def closeness(got, want, tol):
    """(max |got - want|, the largest |got - want| / (atol + rtol |want|),
    which is <= 1 exactly where allclose holds, and the share of elements
    that are bitwise equal)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    worst = float(diff.div_(tol["atol"] + tol["rtol"] * w.abs()).max())
    return err, worst, float((g == w).float().mean())


def compare(name, got, want, tol=KERNEL_TOL, equal_share=None) -> float:
    """Holds ``got`` to ``want`` at ``tol`` and, where ``equal_share`` is
    given, requires at least that share of elements bitwise equal."""
    err, worst, share = closeness(got, want, tol)
    ok = worst <= 1.0 and (equal_share is None or share >= equal_share)
    print(f"  {name}: max_abs_err={err:.3e} (rtol={tol['rtol']:.4g}, "
          f"atol={tol['atol']:.4g}; worst {worst:.3f} of the tolerance), "
          f"bitwise equal {share:.6f}"
          f"{'' if equal_share is None else f' (at least {equal_share})'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name} disagrees with its plain version")
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3: kernels against their plain versions ------------------------


def nan_reading(got, want, tol=KERNEL_TOL):
    """(ok, text): NaN in the same places, infinities equal, and the finite
    elements within ``tol`` (allclose with equal_nan)."""
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    ok = same_nan and bool(torch.allclose(got, want, equal_nan=True, **tol))
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    return ok, (f"NaN {int(torch.isnan(got).sum())} (plain "
                f"{int(torch.isnan(want).sum())}), same places {same_nan}, "
                f"finite max_abs_err={err:.3e}")


def reading(got, want, tol=KERNEL_TOL):
    """(ok, text, max |got - want|) at ``tol``."""
    err, worst, share = closeness(got, want, tol)
    return worst <= 1.0, (f"max_abs_err={err:.3e} (rtol={tol['rtol']:.4g}, "
                          f"atol={tol['atol']:.4g}; worst {worst:.3f} of the "
                          f"tolerance), bitwise equal {share:.6f}"), err


def gnn_inputs(sb, dev):
    """The serving path's inputs from the SubgraphBatch ``sb`` (features
    padded to 512 columns, adjacency, mask, edge lists) and seed-0 weights:
    Fin 512 (layer 0) and 256 (inner layers), Fout 256."""
    gen = torch.Generator().manual_seed(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    x = dict(adj=t(sb.adj), adj_mean=t(sb.adj_mean), mask=t(sb.mask),
             src=t(sb.edge_src), dst=t(sb.edge_dst), w=t(sb.edge_w))
    x["feats"] = t(np.pad(sb.feats, ((0, 0), (0, 0), (0, 512 - F_IN))))
    x["h256"] = torch.relu(torch.randn(C, N, F_HID, generator=gen).to(dev)) \
        * x["mask"][..., None]
    for fin in (512, F_HID):
        x[f"wn{fin}"] = dense_init(gen, (fin, F_HID)).to(dev)
        x[f"ws{fin}"] = dense_init(gen, (fin, F_HID)).to(dev)
    x["b"] = (0.1 * torch.randn(F_HID, generator=gen)).to(dev)
    x["w500"] = dense_init(gen, (F_IN, F_HID)).to(dev)
    x["wb"] = dense_init(gen, (512, 512)).to(dev)
    return x


def fused_rows(x):
    """The fused layer's serving-shape rows: (tag, args, kwargs)."""
    rows = []
    for fin, h in ((512, x["feats"]), (F_HID, x["h256"])):
        for self_w in (False, True):
            args = (x["adj"], h, x[f"wn{fin}"],
                    x[f"ws{fin}"] if self_w else None, x["b"], x["mask"])
            rows.append((f"C={C} N={N} Fin={fin} Fout={F_HID} "
                         f"{'+w_self' if self_w else 'w_neigh'}", args, {}))
    rows.append((f"C={C} N={N} Fin={F_HID} Fout={F_HID} self-only",
                 (None, x["h256"], None, x[f"ws{F_HID}"], x["b"], x["mask"]),
                 dict(act="none")))
    return rows


def fused_checks(x):
    """Every check of ``fused_gnn_layer`` against its plain version:
    [(name, ok, text)]. The serving rows (each launched twice: bitwise
    equal, and all on the tf32x3 kernel), the CPU tests' edge cases and
    block_f invariance."""
    out = []
    for tag, args, kw in fused_rows(x):
        before = fused_kernels.variant_launches["tf32x3"]
        got = fused_gnn_layer(*args, **kw)
        again = fused_gnn_layer(*args, **kw)
        ok, text, _ = reading(got, fused_gnn_layer_ref(*args, **kw))
        same = bool(torch.equal(got, again))
        tf32 = fused_kernels.variant_launches["tf32x3"] == before + 2
        out.append((f"fused {tag}", ok and same and tf32,
                    f"{text}, repeat bitwise {same}, tf32x3 {tf32}"))
    h500 = x["feats"][:2, :64, :F_IN].contiguous()
    a64 = x["adj"][:2, :64, :64].contiguous()
    m64 = x["mask"][:2, :64].contiguous()
    for name, args, kw in (
            ("fused unaligned f_in=500", (a64, h500, x["w500"], None, None,
                                          m64), {}),
            ("fused f_in=500 +w_self", (a64, h500, x["w500"], x["w500"],
                                        x["b"], m64), dict(act="elu")),
            ("fused self-only f_in=500", (None, h500, None, x["w500"], None,
                                          m64), dict(act="none"))):
        ok, text, _ = reading(fused_gnn_layer(*args, **kw),
                              fused_gnn_layer_ref(*args, **kw))
        out.append((name, ok, text))
    b128 = fused_gnn_layer(x["adj"], x["feats"], x["wb"], None, None,
                           x["mask"], block_f=128)
    b256 = fused_gnn_layer(x["adj"], x["feats"], x["wb"], None, None,
                           x["mask"], block_f=256)
    torch.cuda.synchronize()
    same = bool(torch.equal(b128, b256))
    out.append(("fused block_f 128 == 256", same, f"bitwise {same}"))
    return out


def sg_rows(x):
    """The scatter-gather's serving rows: (tag, (src, dst, w, h))."""
    nnz = int((x["w"] != 0).sum())
    return [(f"C={C} N={N} F={f} E={x['src'].shape[1]} real_edges={nnz}",
             (x["src"], x["dst"], x["w"], h))
            for f, h in ((512, x["feats"]),
                         (F_HID, x["feats"][..., :F_HID].contiguous()))]


def sg_checks(x):
    """Every check of ``scatter_gather_aggregate`` against its plain
    version: [(name, ok, text)]. The serving rows (two launches bitwise
    equal), inf and NaN on the source row of the weight-0 padding edges
    (the oracle's 0 * h[src]: NaN where the plain version has it), and 64
    edges into one vertex (exact)."""
    out = []
    for tag, args in sg_rows(x):
        got = scatter_gather_aggregate(*args)
        again = scatter_gather_aggregate(*args)
        ok, text, _ = reading(got, scatter_gather_aggregate_ref(*args))
        same = bool(torch.equal(got, again))
        out.append((f"sg {tag}", ok and same,
                    f"{text}, repeat bitwise {same}"))
    h = x["feats"].clone()
    h[0, N - 1, 1] = float("inf")       # the padding edges' source is N - 1
    h[3, N - 1, 7] = float("nan")
    h[5, N - 1, 300] = float("-inf")
    args = (x["src"], x["dst"], x["w"], h)
    ok, text = nan_reading(scatter_gather_aggregate(*args),
                           scatter_gather_aggregate_ref(*args))
    out.append(("sg weight-0 edges from inf/NaN sources", ok, text))
    raw = scatter_gather_aggregate(
        torch.zeros(1, 64, dtype=torch.int32, device=h.device),
        torch.full((1, 64), 3, dtype=torch.int32, device=h.device),
        torch.ones(1, 64, device=h.device),
        torch.ones(1, 16, 32, device=h.device))
    torch.cuda.synchronize()
    ok = float(raw[0, 3, 0]) == 64.0 and float(raw[0, :3].abs().sum()) == 0.0
    out.append(("sg 64 edges into one vertex", ok, f"out[3] = "
                f"{float(raw[0, 3, 0])}, rows 0-2 sum "
                f"{float(raw[0, :3].abs().sum())}"))
    return out


def gat_rows(x):
    """GAT's serving rows, 4 heads first, then 1, 2 and 8 (head widths 64,
    256, 128, 32): (tag, (z, s_src, s_dst, struct)). z and the scores are
    seed-1 normals; the structure is the real batch's (in-edges plus self
    loops, real columns only, as core/program.py builds it)."""
    if "gat" not in x:
        dev = x["mask"].device
        gen = torch.Generator().manual_seed(1)
        z = torch.randn(C, N, F_HID, generator=gen).to(dev)
        s = torch.randn(2, C, N, 8, generator=gen).to(dev)
        eye = torch.eye(N, device=dev)
        st = ((torch.sign(x["adj_mean"]) + eye)
              * x["mask"][:, None, :]).contiguous()
        x["gat"] = (z, s, st)
    z, s, st = x["gat"]
    nnz = int((st > 0).sum())
    return [(f"C={C} N={N} F={F_HID} heads={h} struct_nnz={nnz}",
             (z, s[0, ..., :h].contiguous(), s[1, ..., :h].contiguous(), st))
            for h in (HEADS, 1, 2, 8)]


def gat_checks(x):
    """Every check of ``gat_attention`` against its plain version:
    [(name, ok, text)]. The serving rows (each launched twice: bitwise
    equal, both on the slab kernel), N=200 on the slab kernel and N=320 on
    the row kernel, an empty row, a dense row, a row whose structural
    scores are all -inf (0) and a dense one (NaN), rows summing to one, and
    inf and NaN in z: outside the structure, behind a structural weight
    that underflows to 0, and behind one that is subnormal (the oracle's
    attn @ z: NaN exactly where the plain version has it)."""
    out = []
    dev = x["mask"].device

    def held(name, args, heads, variant, nan=False):
        before = gat_kernels.variant_launches[variant]
        got = gat_attention(*args, n_heads=heads)
        again = gat_attention(*args, n_heads=heads)
        want = gat_attention_ref(*args, n_heads=heads)
        if nan:
            ok, text = nan_reading(got, want)
        else:
            ok, text, _ = reading(got, want)
        same = bool(torch.equal(got.isnan(), again.isnan())
                    and torch.equal(got.nan_to_num(), again.nan_to_num()))
        on = gat_kernels.variant_launches[variant] == before + 2
        out.append((name, ok and same and on, f"{text}, repeat bitwise "
                    f"{same}, {variant} {on}"))
        return got

    rows = gat_rows(x)
    for tag, args in rows:
        held(f"gat {tag}", args, args[1].shape[-1], "slab")
    z, ss, sd, st = rows[0][1]
    cut = tuple(t[:8, :200, :200].contiguous() if t is st
                else t[:8, :200].contiguous() for t in (z, ss, sd, st))
    held("gat C=8 N=200 heads=4 (slab)", cut, HEADS, "slab")
    gen = torch.Generator().manual_seed(2)
    big = (torch.randn(4, 320, F_HID, generator=gen).to(dev),
           torch.randn(4, 320, HEADS, generator=gen).to(dev),
           torch.randn(4, 320, HEADS, generator=gen).to(dev),
           ((torch.rand(4, 320, 320, generator=gen) < 0.06).float()
            + torch.eye(320)).to(dev))
    held("gat C=4 N=320 heads=4 (row)", big, HEADS, "row")

    st2, sd2 = st.clone(), sd.clone()
    st2[:, 5, :] = 0.0                  # empty
    st2[:, 9, :] = 1.0                  # dense
    sd2[:, 11, :] = float("-inf")       # structural scores all -inf
    st2[:, 13, :] = 1.0                 # dense, all -inf: NaN
    sd2[:, 13, :] = float("-inf")
    got = held("gat empty, dense and all -inf rows", (z, ss, sd2, st2),
               HEADS, "slab", nan=True)
    zero = float(got[:, 5].abs().max()) == 0.0 \
        and float(got[:, 11].abs().max()) == 0.0
    nan13 = bool(torch.isnan(got[:, 13]).all())
    out.append(("gat empty and all -inf rows are 0, the dense all -inf row "
                "NaN", zero and nan13, f"rows 5, 11 zero {zero}, row 13 NaN "
                f"{nan13}"))

    ones = gat_attention(torch.ones(1, 32, 64, device=dev),
                         torch.zeros(1, 32, 1, device=dev),
                         torch.zeros(1, 32, 1, device=dev),
                         torch.ones(1, 32, 32, device=dev), n_heads=1)
    ok, text, _ = reading(ones, torch.ones_like(ones),
                          dict(rtol=1e-5, atol=0.0))
    out.append(("gat rows sum to one", ok, text))

    zb, ssb = z.clone(), ss.clone()
    zb[0, 7, 1] = float("inf")          # rows outside the structure
    zb[3, 100, 70] = float("nan")
    zb[5, N - 1, 200] = float("-inf")
    edges = torch.nonzero((st > 0) & ~torch.eye(N, dtype=torch.bool,
                                                device=dev))
    c, i, j = [int(v) for v in edges[len(edges) // 2]]
    ssb[c, j, 0] = -1e4                 # e ~ -2000 at (i, j): weight 0
    zb[c, j, 3] = float("inf")
    held(f"gat inf/NaN in z outside the structure and behind a weight that "
         f"underflows to 0 (subgraph {c}, {j} -> {i})", (zb, ssb, sd, st),
         HEADS, "slab", nan=True)

    zs = torch.randn(1, 32, 64, generator=gen).to(dev)
    s_src = torch.zeros(1, 32, 1, device=dev)
    s_src[0, 3, 0] = -475.0             # e = -95: exp subnormal, not 0
    zs[0, 3, :] = float("inf")
    st3 = torch.eye(32, device=dev)[None].contiguous()
    st3[0, 0, 3] = 1.0
    held("gat inf in z behind a subnormal weight", (zs, s_src,
         torch.zeros(1, 32, 1, device=dev), st3), 1, "slab", nan=True)
    return out


def run_checks(checks):
    for name, ok, text in checks:
        print(f"  {name}: {text} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} disagrees with its plain version")


def fused_bound(args):
    """(ms, 'bytes' or 'operations'): inputs read once and the output
    written once over 3.35 TB/s, or three tf32 products of every
    multiply-add over 494.7 TFLOP/s (dense TF32), whichever is larger."""
    adj, h, wn, ws, b, mask = args
    Cc, Nn, fin = h.shape
    fout = (wn if wn is not None else ws).shape[1]
    flops = 2.0 * Cc * Nn * fin * fout * ((wn is not None) + (ws is not None))
    if wn is not None:
        flops += 2.0 * Cc * Nn * Nn * fout
    nb = nbytes(adj if wn is not None else None, h, wn, ws, b, mask) \
        + 4 * Cc * Nn * fout
    return bound_ms(nb, 3 * flops, PEAK_TF32_FLOPS)


def kernel_phase(x, dev, label):
    """Checks and times every kernel at the serving shapes of ``x``
    (``gnn_inputs``); returns {kernel: record} for the JSON line."""
    rec = {}

    print("[kernels] fused_gnn_layer", flush=True)
    run_checks(fused_checks(x))
    rows = []
    for tag, args, kw in fused_rows(x):
        err = closeness(fused_gnn_layer(*args, **kw),
                        fused_gnn_layer_ref(*args, **kw), KERNEL_TOL)[0]
        ms = cuda_ms(lambda: fused_gnn_layer(*args, **kw))
        plain = cuda_ms(lambda: fused_gnn_layer_ref(*args, **kw))
        adj, h, wn, ws, b, m = args
        act = ACTS[kw.get("act", "relu")]

        def library():
            if wn is None:
                acc = torch.baddbmm(b, h, ws.expand(C, -1, -1))
            else:
                acc = torch.baddbmm(b, adj, torch.matmul(h, wn))
                if ws is not None:
                    acc = torch.baddbmm(acc, h, ws.expand(C, -1, -1))
            return act(acc) * m[..., None]
        lib = cuda_ms(library)
        bnd, by = fused_bound(args)
        print(f"  fused {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms, bound {bnd:.4f} ms ({by}) [{label}]",
              flush=True)
        rows.append((tag, err, ms, plain, lib, bnd, by))
    tag, err, ms, plain, lib, bnd, by = rows[0]     # gcn layer 0
    check(ms <= lib, f"fused {tag}: the kernel ({ms:.4f} ms) is slower than "
                     f"the baddbmm chain ({lib:.4f} ms)")
    rec["fused_gnn_layer"] = dict(shape=tag, max_abs_err=err, ms=ms,
                                  plain_ms=plain, bound_ms=bnd,
                                  bound_by=by, library_ms=lib)

    print("[kernels] scatter_gather_aggregate", flush=True)
    run_checks(sg_checks(x))
    rows = []
    for tag, args in sg_rows(x):
        src, dst, w, h = args
        f = h.shape[-1]
        err = closeness(scatter_gather_aggregate(*args),
                        scatter_gather_aggregate_ref(*args), KERNEL_TOL)[0]
        ms = cuda_ms(lambda: scatter_gather_aggregate(*args))
        plain = cuda_ms(lambda: scatter_gather_aggregate_ref(*args))
        off = (torch.arange(C, device=dev) * N)[:, None]
        fs, fd = (src.long() + off).reshape(-1), (dst.long() + off).reshape(-1)
        wf = w.reshape(-1, 1)

        def library():
            out = torch.zeros(C * N, f, device=dev)
            return out.index_add_(0, fd, h.reshape(C * N, f)[fs] * wf)
        lib = cuda_ms(library)
        nnz = int((w != 0).sum())
        bnd, by = bound_ms(nbytes(src, dst, w, h) + 4 * C * N * f,
                           2.0 * nnz * f)
        print(f"  sg {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms, bound {bnd:.4f} ms ({by}) [{label}]",
              flush=True)
        rows.append((tag, err, ms, plain, lib, bnd, by))
    tag, err, ms, plain, lib, bnd, by = rows[0]     # layer-0 width
    rec["scatter_gather_aggregate"] = dict(
        shape=tag, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
        bound_by=by, library_ms=lib)

    print("[kernels] gat_attention", flush=True)
    run_checks(gat_checks(x))
    tag, args = gat_rows(x)[0]                      # 4 heads
    err = closeness(gat_attention(*args, n_heads=HEADS),
                    gat_attention_ref(*args, n_heads=HEADS), KERNEL_TOL)[0]
    before = dict(gat_kernels.variant_launches)
    ms = cuda_ms(lambda: gat_attention(*args, n_heads=HEADS))
    variant = ",".join(k for k, n in gat_kernels.variant_launches.items()
                       if n > before[k])
    plain = cuda_ms(lambda: gat_attention_ref(*args, n_heads=HEADS))
    nnz_s = int((args[3] > 0).sum())
    bnd, by = bound_ms(nbytes(*args) + 4 * C * N * F_HID,
                       2.0 * nnz_s * F_HID + 6.0 * C * HEADS * N * N)
    print(f"  gat {tag}: kernel {ms:.4f} ms ({variant}), plain {plain:.4f} "
          f"ms, library none, bound {bnd:.4f} ms ({by}) [{label}]",
          flush=True)
    rec["gat_attention"] = dict(shape=tag, variant=variant, max_abs_err=err,
                                ms=ms, plain_ms=plain, bound_ms=bnd,
                                bound_by=by, library_ms=None)
    return rec


# -- phase 3b: the scatter-gather's bucket kernel and the bf16 kernels -------


def big_batch(graph, targets):
    """A forced-sg batch of the Flickr-sized graph at N=1024 and C=8, as the
    engine plans it (its edge budget is default_edge_pad's 74,496 slots)."""
    with DecoupledEngine(graph, GNNConfig(
            kind="gcn", n_layers=LAYERS, receptive_field=BIG_N, f_in=F_IN,
            f_hidden=F_HID), config=ServingConfig(
            device="cuda", batch_size=BIG_C, mode="sg")) as eng:
        sb = eng.plan(targets[:BIG_C]).sb
        e_pad = eng.e_pad
    print(f"[data] batch C={BIG_C} N={BIG_N} e_pad={e_pad} mean real edges "
          f"{sb.n_edges.mean():.1f}", flush=True)
    return sb


def sg_wide_rows(x, big, dev):
    """The bucket kernel's rows, (tag, (src, dst, w, h)): the serving batch's
    edge lists padded to 65,537 slots with weight-0 edges at N-1 (F=256),
    and the N=1024 batch (F=256: its first 256 feature columns)."""
    if "wide" not in x:
        pad = WIDE_E - x["src"].shape[1]
        fill = torch.full((C, pad), N - 1, dtype=torch.int32, device=dev)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        x["wide"] = [
            (f"C={C} N={N} F={F_HID} E={WIDE_E} (serving batch, padded)",
             (torch.cat([x["src"], fill], 1), torch.cat([x["dst"], fill], 1),
              torch.cat([x["w"], torch.zeros((C, pad), device=dev)], 1),
              x["feats"][..., :F_HID].contiguous())),
            (f"C={BIG_C} N={BIG_N} F={F_HID} E={big.edge_src.shape[1]} "
             f"real_edges={int((big.edge_w != 0).sum())}",
             (t(big.edge_src), t(big.edge_dst), t(big.edge_w),
              t(big.feats[..., :F_HID])))]
    return x["wide"]


def sg_bucket_checks(x, big, dev):
    """The bucket kernel against its plain version: [(name, ok, text)]. Its
    rows (two launches bitwise equal, both on the bucket kernel), and inf
    and NaN on the source row of the N=1024 batch's weight-0 padding edges
    (NaN exactly where the plain version puts it)."""
    out = []
    rows = sg_wide_rows(x, big, dev)
    for tag, args in rows:
        check(sg_variant(args[3].shape[1], args[0].shape[1]) == "bucket",
              f"sg {tag}: not a shape of the bucket kernel")
        before = sg_kernels.variant_launches["bucket"]
        got = scatter_gather_aggregate(*args)
        again = scatter_gather_aggregate(*args)
        ok, text, _ = reading(got, scatter_gather_aggregate_ref(*args))
        same = bool(torch.equal(got, again))
        on = sg_kernels.variant_launches["bucket"] == before + 2
        out.append((f"sg bucket {tag}", ok and same and on,
                    f"{text}, repeat bitwise {same}, bucket {on}"))
    src, dst, w, h = rows[1][1]
    h = h.clone()
    h[0, BIG_N - 1, 1] = float("inf")    # the padding edges' source
    h[3, BIG_N - 1, 7] = float("nan")
    h[5, BIG_N - 1, 200] = float("-inf")
    ok, text = nan_reading(scatter_gather_aggregate(src, dst, w, h),
                           scatter_gather_aggregate_ref(src, dst, w, h))
    out.append((f"sg bucket N={BIG_N} weight-0 edges from inf/NaN sources",
                ok, text))
    return out


def bf16_rows(x, big, dev):
    """The three GNN kernels' bf16 rows at the serving shapes: (kernel, tag,
    args, kwargs); h, z, the weights and b in bf16, the rest fp32."""
    bf = lambda t: None if t is None else t.to(torch.bfloat16)  # noqa: E731
    rows = []
    for tag, (adj, h, wn, ws, b, m), kw in fused_rows(x):
        rows.append(("fused_gnn_layer", f"{tag} bf16",
                     (adj, bf(h), bf(wn), bf(ws), bf(b), m), kw))
    for tag, (src, dst, w, h) in sg_rows(x) + sg_wide_rows(x, big, dev)[1:]:
        rows.append(("scatter_gather_aggregate", f"{tag} bf16",
                     (src, dst, w, bf(h)), {}))
    tag, (z, ss, sd, st) = gat_rows(x)[0]
    rows.append(("gat_attention", f"{tag} bf16", (bf(z), ss, sd, st),
                 dict(n_heads=HEADS)))
    return rows


def widened(args):
    """``args`` with every floating tensor in fp32 (the plain version's
    fp32 result on a bf16 row's inputs)."""
    return [a.float() if a is not None and a.is_floating_point() else a
            for a in args]


KERNELS_BY_NAME = {"fused_gnn_layer": (fused_gnn_layer, fused_gnn_layer_ref,
                                       fused_kernels),
                   "scatter_gather_aggregate": (
                       scatter_gather_aggregate,
                       scatter_gather_aggregate_ref, sg_kernels),
                   "gat_attention": (gat_attention, gat_attention_ref,
                                     gat_kernels)}


def bf16_checks(x, big, dev):
    """Each bf16 row against its plain version's fp32 result on the same
    (bf16) inputs: within one bf16 ulp of it rounded to bf16 outside the
    fp32 kernels' 2e-5 (``bf16_reading``), within the reference's 2e-2,
    output in bf16, two launches bitwise equal. [(name, ok, text)]"""
    out = []
    for kernel, tag, args, kw in bf16_rows(x, big, dev):
        fn, ref, mod = KERNELS_BY_NAME[kernel]
        before = dict(mod.variant_launches)
        got = fn(*args, **kw)
        again = fn(*args, **kw)
        variant = ",".join(k for k, n in mod.variant_launches.items()
                           if n > before[k])
        ok, worst, err = bf16_reading(got, ref(*widened(args), **kw))
        same = bool(torch.equal(got.isnan(), again.isnan())
                    and torch.equal(got.nan_to_num(), again.nan_to_num()))
        out.append((f"{kernel} {tag}", ok and same
                    and got.dtype == torch.bfloat16,
                    f"max_abs_err={err:.3e} against the fp32 result, worst "
                    f"{worst} bf16 ulp outside 2e-5, repeat bitwise {same}, "
                    f"{variant}"))
    return out


def fused_bf16_bound(args):
    """(ms, by) of a bf16 fused call: its bytes, or its bf16 products over
    989 TFLOP/s plus A.HW's fp32 product (three tf32 products) over 494.7
    TFLOP/s, whichever is larger."""
    adj, h, wn, ws, b, mask = args
    Cc, Nn, fin = h.shape
    fout = (wn if wn is not None else ws).shape[1]
    t_ops = 2.0 * Cc * Nn * fin * fout * ((wn is not None) + (ws is not None)) \
        / PEAK_BF16_FLOPS
    if wn is not None:
        t_ops += 3 * 2.0 * Cc * Nn * Nn * fout / PEAK_TF32_FLOPS
    nb = nbytes(adj if wn is not None else None, h, wn, ws, b, mask) \
        + h.element_size() * Cc * Nn * fout
    t_bytes = nb / PEAK_BYTES_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops \
        else (t_ops * 1e3, "operations")


def sg_bound(args):
    src, dst, w, h = args
    Cc, Nn, f = h.shape
    return bound_ms(nbytes(src, dst, w, h) + h.element_size() * Cc * Nn * f,
                    2.0 * int((w != 0).sum()) * f)


def sg_library(args):
    """``index_add_`` of the weighted source rows, in h's dtype."""
    src, dst, w, h = args
    Cc, Nn, f = h.shape
    off = (torch.arange(Cc, device=h.device) * Nn)[:, None]
    fs, fd = (src.long() + off).reshape(-1), (dst.long() + off).reshape(-1)
    wf = w.reshape(-1, 1).to(h.dtype)
    return lambda: torch.zeros(Cc * Nn, f, dtype=h.dtype,
                               device=h.device).index_add_(
        0, fd, h.reshape(Cc * Nn, f)[fs] * wf)


def variant_phase(graph, targets, x, dev, label):
    """Checks and times the scatter-gather's bucket kernel and the three GNN
    kernels in bf16; returns {kernel: [variant record]} for the JSON
    line."""
    big = big_batch(graph, targets)
    print("[kernels] scatter_gather_aggregate bucket", flush=True)
    run_checks(sg_bucket_checks(x, big, dev))
    print("[kernels] bf16", flush=True)
    run_checks(bf16_checks(x, big, dev))
    recs = {k: [] for k in KERNELS_BY_NAME}
    timed = [("scatter_gather_aggregate", f"bucket {tag}", args, {})
             for tag, args in sg_wide_rows(x, big, dev)] + \
        bf16_rows(x, big, dev)
    for kernel, tag, args, kw in timed:
        fn, ref, mod = KERNELS_BY_NAME[kernel]
        before = dict(mod.variant_launches)
        ms = cuda_ms(lambda: fn(*args, **kw))
        variant = ",".join(k for k, n in mod.variant_launches.items()
                           if n > before[k])
        plain = cuda_ms(lambda: ref(*args, **kw))
        got = fn(*args, **kw)
        if got.dtype == torch.bfloat16:
            err = bf16_reading(got, ref(*widened(args), **kw))[2]
        else:
            err = closeness(got, ref(*args, **kw), KERNEL_TOL)[0]
        if kernel == "fused_gnn_layer":
            adj, h, wn, ws, b, m = args
            act = ACTS[kw.get("act", "relu")]
            a16 = adj.to(h.dtype) if adj is not None else None

            def library():
                if wn is None:
                    acc = torch.baddbmm(b, h, ws.expand(h.shape[0], -1, -1))
                else:
                    acc = torch.baddbmm(b, a16, torch.matmul(h, wn))
                    if ws is not None:
                        acc = torch.baddbmm(acc, h,
                                            ws.expand(h.shape[0], -1, -1))
                return act(acc) * m[..., None].to(h.dtype)
            lib = cuda_ms(library)
            bnd, by = fused_bf16_bound(args)
            lib_name = "baddbmm chain, bf16"
        elif kernel == "scatter_gather_aggregate":
            lib = cuda_ms(sg_library(args))
            bnd, by = sg_bound(args)
            lib_name = f"index_add_, {str(args[3].dtype)[6:]}"
        else:
            z, ss, sd, st = args
            lib, lib_name = None, "none"
            nnz_s = int((st > 0).sum())
            bnd, by = bound_ms(nbytes(*args) + z.element_size() * z.numel(),
                               2.0 * nnz_s * z.shape[-1]
                               + 6.0 * z.shape[0] * HEADS * z.shape[1] ** 2)
        print(f"  {kernel} {tag}: kernel {ms:.4f} ms ({variant}), plain "
              f"{plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'} ({lib_name}), "
              f"bound {bnd:.4f} ms ({by}) [{label}]", flush=True)
        recs[kernel].append(dict(
            variant=variant, shape=tag, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib))
    return recs


# -- phase 4: flash_attention against its plain version --------------------


def flash_wgmma_check(name, q, k, v, causal=True):
    """Runs the wgmma kernel twice and holds it to ``flash_bf16_check``;
    returns the readings."""
    check(flash_variant(q.dtype, q.shape[-1]) == "wgmma",
          f"{name}: not a shape of the wgmma kernel")
    before = flash_kernels.variant_launches["wgmma"]
    out = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(flash_kernels.variant_launches["wgmma"] == before + 2,
          f"{name}: the wgmma kernel was not launched")
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal)
    r = flash_bf16_check(out, again, want,
                         flash_bf16_tol(q, k, v, causal=causal))
    print(f"  {name}: max_abs_err={r['max_abs_err']:.3e}, worst "
          f"{r['worst']:.3f} of flash_bf16_tol, mean signed error "
          f"{r['bias_ulp']:+.4f} ulp, repeatable {r['repeatable']} "
          f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
    check(r["ok"], f"{name} disagrees with its plain version")
    return r


def flash_phase(dev, label):
    """Checks both flash_attention kernels on the CPU tests' shapes and the
    wgmma kernel at the prefill's shape, times it there; returns its
    record."""
    print("[kernels] flash_attention", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for b, h, kh, sq, sk, d in ((1, 2, 2, 64, 64, 32), (2, 1, 1, 128, 128, 64),
                                (1, 2, 2, 64, 128, 32),
                                (1, 3, 3, 1000, 1000, 64),
                                (1, 2, 2, 1000, 1000, 128),
                                (1, 2, 2, 1000, 777, 128),
                                (1, 4, 2, 1000, 1000, 128)):
        q, k, v = rnd((b, h, sq, d)), rnd((b, kh, sk, d)), rnd((b, kh, sk, d))
        for causal in (True, False):
            compare(f"flash cuda_core fp32 B={b} H={h} Kh={kh} Sq={sq} "
                    f"Sk={sk} D={d} causal={causal}",
                    flash_attention(q, k, v, causal=causal),
                    flash_attention_ref(q, k, v, causal=causal))
    q, k, v = (rnd((1, 4, 1000, 32), torch.bfloat16) for _ in range(3))
    check(flash_variant(q.dtype, 32) == "cuda_core", "bf16 D=32 variant")
    compare("flash cuda_core bf16 B=1 H=4 S=1000 D=32 causal",
            flash_attention(q, k, v), flash_attention_ref(q, k, v),
            FLASH_BF16_TOL, FLASH_BF16_EQUAL)
    for b, h, kh, sq, sk, d, causal in (
            (1, 1, 1, 128, 128, 128, True), (1, 2, 1, 128, 128, 64, True),
            (2, 4, 2, 1000, 1000, 128, True), (1, 4, 1, 1000, 777, 64, True),
            (1, 2, 2, 130, 300, 128, False), (2, 2, 1, 256, 256, 64, False)):
        q = rnd((b, h, sq, d), torch.bfloat16)
        k, v = (rnd((b, kh, sk, d), torch.bfloat16) for _ in range(2))
        flash_wgmma_check(f"flash wgmma B={b} H={h} Kh={kh} Sq={sq} Sk={sk} "
                          f"D={d} causal={causal}", q, k, v, causal)
    B, H, KH, S, D = 1, 40, 10, LM_SEQ, 128
    q = rnd((B, H, S, D), torch.bfloat16)
    k, v = (rnd((B, KH, S, D), torch.bfloat16) for _ in range(2))
    tag = f"B={B} H={H} Kh={KH} S={S} D={D} bf16 causal"
    r = flash_wgmma_check(f"flash wgmma {tag}", q, k, v)
    ms = cuda_ms(lambda: flash_attention(q, k, v), iters=20)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v), iters=5,
                    warmup=1)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=20)
    flops = flash_cost(B, H, S, S, D, causal=True)["flops"]
    bnd, by = bound_ms(2 * nbytes(q) + nbytes(k, v), flops, PEAK_BF16_FLOPS)
    print(f"  flash wgmma {tag}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, library "
          f"{lib:.4f} ms (scaled_dot_product_attention), bound {bnd:.4f} "
          f"ms ({by}; {flops:.4g} operations, "
          f"{2 * nbytes(q) + nbytes(k, v):.4g} bytes) [{label}]", flush=True)
    k4, v4 = (t.repeat_interleave(H // KH, dim=1) for t in (k, v))
    ms4 = cuda_ms(lambda: flash_attention(q, k4, v4), iters=20)
    lib4 = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k4, v4, is_causal=True), iters=20)
    print(f"  flash wgmma B={B} H={H} Kh={H} S={S} D={D} bf16 causal (K/V "
          f"repeated, PR 12's shape): kernel {ms4:.4f} ms, library "
          f"{lib4:.4f} ms [{label}]", flush=True)
    return dict(shape=tag, variant="wgmma", max_abs_err=r["max_abs_err"],
                ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib)


# -- phase 5: the serving path ---------------------------------------------


def engine_phase(graph, targets, label):
    """Serves every (model, mode) through the kernels, then through plain
    PyTorch, and compares. Returns the main path's launch counts."""
    outs, params = {}, {}
    ops.reset_launch_counts()
    for kind in ("gcn", "sage", "gat"):
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        params[kind] = init_gnn(cfg, seed=0, device="cuda")
        for mode in ("dense", "sg"):
            conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                                 impl="cuda")
            with DecoupledEngine(graph, cfg, params=params[kind],
                                 config=conf) as eng:
                before = ops.launch_counts()
                eng.infer(targets[:C])                   # warm-up batch
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                res = eng.infer(targets)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                after = ops.launch_counts()
            st = res.stats
            per = [h + d for h, d in zip(st.host_times, st.device_times)]
            delta = {k: after[k] - before[k] for k in after}
            want = {k: EXPECTED[kind, mode].get(k, 0) * (N_BATCHES + 1)
                    for k in after}
            check(res.embeddings.shape == (len(targets), F_HID)
                  and np.isfinite(res.embeddings).all(),
                  f"{kind}/{mode}: bad embeddings")
            check(delta == want, f"{kind}/{mode}: launches {delta}, "
                                 f"expected {want}")
            print(f"[engine] {kind}/{mode}: {N_BATCHES} batches x C={C}, "
                  f"p50 batch host+device {statistics.median(per)*1e3:.2f} "
                  f"ms (p50 device {statistics.median(st.device_times)*1e3:.2f}"
                  f" ms), wall/batch {st.t_wall/N_BATCHES*1e3:.2f} ms, "
                  f"overlap {st.overlap_fraction:.3f}, peak device memory "
                  f"{peak/2**20:.1f} MiB, launches/batch "
                  f"{ {k: v // (N_BATCHES + 1) for k, v in delta.items()} }, "
                  f"host stage totals "
                  f"{ {k: round(v, 4) for k, v in st.stage_times.items()} } "
                  f"s [{label}]", flush=True)
            outs[kind, mode] = res.embeddings
    main_path = ops.launch_counts()
    variants = dict(fused_kernels.variant_launches)
    print(f"[engine] fused_gnn_layer launches by kernel over the six "
          f"engines: {variants} [{label}]", flush=True)
    check(variants == {"tf32x3": main_path["fused_gnn_layer"],
                       "cuda_core": 0},
          f"fused_gnn_layer launches by kernel {variants}, expected all "
          f"{main_path['fused_gnn_layer']} on the tf32x3 kernel")
    gat_split = dict(gat_kernels.variant_launches)
    print(f"[engine] gat_attention launches by kernel over the six engines: "
          f"{gat_split} (gat_variant({N}, {F_HID}, {HEADS}, aligned=True) "
          f"= {gat_variant(N, F_HID, HEADS, aligned=True)!r}) [{label}]",
          flush=True)
    check(gat_split == {"slab": main_path["gat_attention"], "row": 0},
          f"gat_attention launches by kernel {gat_split}, expected all "
          f"{main_path['gat_attention']} on the slab kernel")
    sg_split = dict(sg_kernels.variant_launches)
    print(f"[engine] scatter_gather_aggregate launches by kernel over the six "
          f"engines: {sg_split} [{label}]", flush=True)
    check(sg_split == {"sort": main_path["scatter_gather_aggregate"],
                       "bucket": 0},
          f"scatter_gather_aggregate launches by kernel {sg_split}, expected "
          f"all {main_path['scatter_gather_aggregate']} on the sort kernel")
    for (kind, mode), got in outs.items():
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                             impl="torch")
        with DecoupledEngine(graph, cfg, params=params[kind],
                             config=conf) as eng:
            want = eng.infer(targets).embeddings
        err = float(np.abs(got - want).max())
        rel = float((np.abs(got - want) / (np.abs(want) + 1e-6)).max())
        ok = np.allclose(got, want, **ENGINE_TOL)
        print(f"[engine] {kind}/{mode} cuda vs torch: max_abs_err "
              f"{err:.3e}, max_rel_err {rel:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{kind}/{mode}: kernels disagree with plain PyTorch")
    check(ops.launch_counts() == main_path,
          "the impl='torch' engines launched a kernel")
    return main_path


# -- phase 5b: the multi-model server ----------------------------------------


def serve_phase(graph, label):
    """One GNNServer on the Flickr-sized graph serving GCN (sg:
    scatter_gather_aggregate), GraphSAGE (dense, resident store: the fused
    layer's A.(H.W)+H.Ws form) and GAT (dense: gat_attention) under one H100
    DSE plan; 3 x 192 Zipf(1.1) requests routed by model. Checks every
    embedding against the same engine's infer, the launch counts against the
    lanes' batches, and that a model outside the plan raises PlanViolation
    at register. Returns the server path's launch counts."""
    engines = {}
    for kind, lane in SERVE_LANES.items():
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        engines[kind] = DecoupledEngine(graph, cfg, config=ServingConfig(
            device="cuda", batch_size=C, mode=lane["mode"], impl="cuda",
            store=StorePolicy(features=lane.get("features", "dense"))))
    srv = GNNServer()
    for kind, eng in engines.items():
        srv.register(kind, eng)
    plan = srv.plan
    print(f"[serve] plan (H100 DSE over {', '.join(engines)}): block_f="
          f"{plan.block_f} c_core={plan.c_core} smem_used={plan.smem_used} "
          f"bytes a block, ops_ok={plan.ops_ok} [{label}]", flush=True)
    refused = GNNConfig(kind="gat", n_layers=2, receptive_field=8192,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
    reasons = plan_covers(plan, refused, H100Spec())
    check(bool(reasons), "plan_covers takes GAT at N=8192")
    with DecoupledEngine(graph, refused, config=ServingConfig(
            device="cuda", batch_size=1)) as eng:
        try:
            srv.register("gat-8192", eng)
        except PlanViolation as e:
            print(f"[serve] register GAT N=8192: PlanViolation ({e}) ok",
                  flush=True)
        else:
            check(False, "register took a model outside the plan")
    rng = np.random.default_rng(3)
    traffic = {k: zipf_traffic(graph, SERVE_REQUESTS, a=1.1,
                               seed=int(rng.integers(1 << 30)))
               for k in engines}
    order = [(k, int(t)) for i in range(SERVE_REQUESTS)
             for k, ts in traffic.items() for t in ts[i:i + 1]]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv.start()
    reqs = [srv.submit(t, model=k) for k, t in order]
    srv.drain(reqs, timeout=600)
    srv.stop()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    served = ops.launch_counts()
    variants = {name: dict(m.variant_launches) for name, m in
                (("fused", fused_kernels), ("sg", sg_kernels),
                 ("gat", gat_kernels))}
    rep = srv.report()
    batches = {k: srv.model_stats(k).n_batches for k in engines}
    want = {k: 0 for k in served}
    for kind, lane in SERVE_LANES.items():
        for kname, n in EXPECTED[kind, lane["mode"]].items():
            want[kname] += n * batches[kind]
    print(f"[serve] {len(reqs)} requests in {wall:.2f} s wall; batches "
          f"{batches}; launches {served} (expected {want}); by kernel "
          f"{variants} [{label}]", flush=True)
    check(served == want, f"server launches {served}, expected {want}")
    check(variants["fused"]["tf32x3"] == served["fused_gnn_layer"]
          and variants["sg"]["sort"] == served["scatter_gather_aggregate"]
          and variants["gat"]["slab"] == served["gat_attention"],
          f"server launches by kernel {variants}: expected every fused "
          f"launch on tf32x3, every sg launch on sort, every GAT on slab")
    for kind in engines:
        m = rep["models"][kind]
        lat, st = m["latency"], m["store"]
        print(f"[serve] {kind} ({SERVE_LANES[kind]['mode']}, "
              f"{st['features']['strategy']} store): n={lat['n']} p50 "
              f"{lat['p50'] * 1e3:.2f} ms p90 {lat['p90'] * 1e3:.2f} ms p99 "
              f"{lat['p99'] * 1e3:.2f} ms, overlap "
              f"{m['stages']['overlap']:.3f}, bytes shipped "
              f"{st['bytes_shipped']} of {st['bytes_dense']} dense "
              f"({st['bytes_shipped'] / max(1, m['stages']['batches']):.0f}"
              f" a batch, transfer ratio {st['transfer_ratio']}) [{label}]",
              flush=True)
        check(lat["n"] == SERVE_REQUESTS, f"{kind}: {lat['n']} answered")
    res = rep["models"]["sage"]["store"]
    dense = rep["models"]["gat"]["store"]
    print(f"[serve] resident store (sage): {res['features']['device_bytes']}"
          f" bytes on the card, hit rate "
          f"{res['features']['resident_hit_rate']}; a batch ships "
          f"{res['bytes_shipped'] / rep['models']['sage']['stages']['batches']:.0f}"
          f" bytes against "
          f"{dense['bytes_shipped'] / rep['models']['gat']['stages']['batches']:.0f}"
          f" for the dense store (gat) [{label}]", flush=True)
    for kind, eng in engines.items():
        mine = [r for r in reqs if r.model == kind]
        got = np.stack([r.embedding for r in mine])
        want_emb = eng.infer(np.array([r.target for r in mine])).embeddings
        err = float(np.abs(got - want_emb).max())
        ok = got.shape == (SERVE_REQUESTS, F_HID) \
            and np.isfinite(got).all() \
            and np.allclose(got, want_emb, **ENGINE_TOL)
        print(f"[serve] {kind} server vs the engine's infer: max_abs_err "
              f"{err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kind}: served embeddings disagree with infer")
        eng.close()
    return served


def repeatability_phase(graph, targets, label):
    """Two device steps of one planned gat/sg and gcn/sg batch, under
    impl="torch" and impl="cuda": whether the two are bitwise equal, and
    their largest difference. The plain sg paths (gnn/layers.py agg_sg,
    core/program.py's sg softmax, which both impls run for gat/sg) sum with
    ``index_add_``."""
    for kind, impl in (("gat", "torch"), ("gcn", "torch"), ("gat", "cuda"),
                       ("gcn", "cuda")):
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        with DecoupledEngine(graph, cfg, params=init_gnn(
                cfg, seed=0, device="cuda"), config=ServingConfig(
                device="cuda", batch_size=C, mode="sg", impl=impl)) as eng:
            plan = eng.plan(targets[:C])
            a = eng.run_device(plan).clone()
            b = eng.run_device(plan).clone()
            torch.cuda.synchronize()
        same = bool(torch.equal(a, b))
        diff = float((a - b).abs().max())
        print(f"[repeat] {kind}/sg impl={impl}: two device steps of one "
              f"batch bitwise equal {same}, max |difference| {diff:.3e}, "
              f"share of elements equal {float((a == b).float().mean()):.6f}"
              f" [{label}]", flush=True)


# -- phase 6: LM prefill and decode ------------------------------------------


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _agreement(got, want):
    """(max |got - want| / max |want|, share of equal argmaxes)."""
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, top1


def _profile(fn, label, what, tag="lm", top=8):
    """Prints the device time of one call of ``fn`` by kernel, from
    ``torch.profiler``, and the share of the call's wall time the card
    was busy (one stream: the kernels' and copies' times add up)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = _timed(fn)[1]
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    print(f"[{tag}] profile of {what}: device {busy * 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall ({busy / wall:.1%} busy; traced) "
          f"[{label}]", flush=True)
    for name, us, count in rows[:top]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms  x{count:<4d} {name[:80]}",
              flush=True)
    if len(rows) > top:
        rest, count = (sum(r[k] for r in rows[top:]) for k in (1, 2))
        print(f"[{tag}]   {rest / 1e3:9.3f} ms  x{count:<4d} "
              f"{len(rows) - top} other kernels and copies", flush=True)


def profile_phase(graph, targets, label):
    """One traced device step (``DecoupledEngine.run_device``: the batch's
    copy to the card and the program) of a gat/dense and a gcn/sg batch,
    planned on the host first, after one untraced warm-up step: the device
    time by kernel and copy, and the card's busy share of the step."""
    for kind, mode in (("gat", "dense"), ("gcn", "sg")):
        cfg = GNNConfig(kind=kind, n_layers=LAYERS, receptive_field=N,
                        f_in=F_IN, f_hidden=F_HID, n_heads=HEADS)
        conf = ServingConfig(device="cuda", batch_size=C, mode=mode,
                             impl="cuda")
        with DecoupledEngine(graph, cfg, params=init_gnn(
                cfg, seed=0, device="cuda"), config=conf) as eng:
            plan = eng.plan(targets[:C])
            _timed(lambda: eng.run_device(plan))
            _profile(lambda: eng.run_device(plan), label,
                     f"one {kind}/{mode} engine batch's device step (C={C}, "
                     f"L={LAYERS})", tag="engine", top=12)


def lm_phase(label):
    """Serves one 8192-token prompt of phi3-medium-14b (8 layers) through
    prefill and decode; returns the main path's launch counts."""
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    params, t_init = _timed(lambda: transformer.init_params(
        cfg, seed=0, device="cuda"))
    n_params = param_count(params)
    print(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers} "
          f"(of 40): {n_params / 1e9:.3f} B parameters, "
          f"{n_params * 4 / 1e9:.2f} GB fp32, drawn on the card in "
          f"{t_init:.2f} s", flush=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LM_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}

    def prefill(impl, b=batch):
        return _timed(lambda: transformer.prefill(cfg, params, b, impl=impl))

    prefill("cuda")                        # warm-up: cuBLAS, first launches
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, t_main = prefill("cuda")
    launches = ops.launch_counts()
    variants = dict(flash_kernels.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    want = {k: (cfg.n_layers if k == "flash_attention" else 0)
            for k in launches}
    check(launches == want, f"prefill launches {launches}, expected {want}")
    check(variants == {"wgmma": cfg.n_layers, "cuda_core": 0},
          f"prefill's flash_attention launches by kernel {variants}, "
          f"expected all {cfg.n_layers} on the wgmma kernel")
    check(tuple(logits.shape) == (1, LM_SEQ, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    times = [t_main] + [prefill("cuda")[1] for _ in range(2)]
    print(f"[lm] prefill impl=cuda B=1 S={LM_SEQ}: latency "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms (p50 "
          f"{statistics.median(times) * 1e3:.2f} ms), "
          f"{LM_SEQ / statistics.median(times):.0f} tokens/s, peak device "
          f"memory {peak / 2**30:.2f} GiB, launches {launches} (flash by "
          f"kernel {variants}) [{label}]",
          flush=True)

    _profile(lambda: prefill("cuda"), label, "one prefill")

    before = ops.launch_counts()
    plain, t_plain = prefill("torch")
    check(ops.launch_counts() == before, "impl='torch' launched a kernel")
    rel, top1 = _agreement(logits, plain)
    ok = rel <= LM_TOL["rel"] and top1 >= LM_TOL["top1"]
    print(f"[lm] prefill impl=cuda vs impl=torch: max abs err / max |logit| "
          f"{rel:.3e} (max |logit| {float(plain.abs().max()):.3f}), top-1 "
          f"agreement {top1:.4f} over {LM_SEQ} positions (tolerance "
          f"{LM_TOL}); impl=torch latency {t_plain * 1e3:.2f} ms "
          f"{'ok' if ok else 'FAIL'} [{label}]", flush=True)
    check(ok, "prefill through the kernel disagrees with the plain path")
    del logits, plain

    cache = transformer.init_cache(cfg, 1, LM_DECODE, device="cuda")
    steps, step_times = [], []
    for pos in range(LM_DECODE):
        (lg, cache), t = _timed(lambda: transformer.decode_step(
            cfg, params, cache, batch["tokens"][:, pos:pos + 1], pos))
        steps.append(lg[:, 0])
        step_times.append(t)
    dec = torch.stack(steps, dim=1)
    check(tuple(dec.shape) == (1, LM_DECODE, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()), "bad decode logits")
    ref, _ = prefill("cuda", {"tokens": batch["tokens"][:, :LM_DECODE]})
    rel, top1 = _agreement(dec, ref)
    ok = rel <= DECODE_TOL["rel"] and top1 >= DECODE_TOL["top1"]
    p50 = statistics.median(step_times[1:])
    print(f"[lm] decode {LM_DECODE} steps from an empty cache vs prefill "
          f"of the same tokens: max abs err / max |logit| {rel:.3e}, top-1 "
          f"agreement {top1:.4f} (tolerance {DECODE_TOL}); step latency "
          f"p50 {p50 * 1e3:.2f} ms (first {step_times[0] * 1e3:.2f} ms), "
          f"{1 / p50:.1f} tokens/s at B=1 {'ok' if ok else 'FAIL'} "
          f"[{label}]", flush=True)
    check(ok, "decode disagrees with prefill")
    _profile(lambda: transformer.decode_step(
        cfg, params, cache, batch["tokens"][:, LM_DECODE - 1:LM_DECODE],
        LM_DECODE - 1), label, "one decode step")
    return launches


def serving_batch():
    """The Flickr-sized graph, the Zipf targets of every measured batch,
    and the first batch as the engine plans it (SubgraphBatch)."""
    t0 = time.perf_counter()
    graph = get_graph("flickr", scale=1.0)
    targets = zipf_traffic(graph, N_BATCHES * C, seed=0)
    print(f"[data] flickr V={graph.num_vertices} E={graph.num_edges} "
          f"f_in={graph.feature_dim} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    with DecoupledEngine(graph, GNNConfig(
            kind="gcn", n_layers=LAYERS, receptive_field=N, f_in=F_IN,
            f_hidden=F_HID), config=ServingConfig(
            device="cuda", batch_size=C, mode="sg")) as eng:
        sb = eng.plan(targets[:C]).sb
        e_pad = eng.e_pad
    print(f"[data] batch C={C} N={N} e_pad={e_pad} mean real edges "
          f"{sb.n_edges.mean():.1f}", flush=True)
    return graph, targets, sb


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name_power = card()
    label = name_power
    print(f"[env] {name_power}", flush=True)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    reports = build.build()
    print(f"[build] {len(reports)} libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {k}: {line.strip()}", flush=True)
    graph, targets, sb = serving_batch()
    dev = torch.device("cuda")
    x = gnn_inputs(sb, dev)
    rec = kernel_phase(x, dev, label)
    variants = variant_phase(graph, targets, x, dev, label)
    del x
    rec["flash_attention"] = flash_phase(dev, label)
    launches = engine_phase(graph, targets, label)
    profile_phase(graph, targets, label)
    served = serve_phase(graph, label)
    repeatability_phase(graph, targets, label)
    launches["flash_attention"] = lm_phase(label)["flash_attention"]
    for k in REPLACES:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    for k in KERNELS_BY_NAME:
        check(served[k] > 0, f"{k} was never launched on the server path")
    kernels = []
    for k, (source, replaces) in REPLACES.items():
        kernels.append(dict(name=k, route="cuda", source=source,
                            replaces=replaces,
                            launches=launches[k] + served.get(k, 0),
                            **rec[k], variants=variants.get(k, [])))
    print(name_power, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
