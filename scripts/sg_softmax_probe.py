#!/usr/bin/env python3
"""GAT's sg softmax sums on the card: one scatter-gather launch or two.

    python3 scripts/sg_softmax_probe.py

``core/program.py``'s ``_sg_softmax_sums`` sums the softmax's numerator
and denominator in one launch of the sort scatter-gather over h = [z_head
| 1 | 0...] (68 columns a head at the serving width), then divides. The
form it replaced (kept here as ``two_launch_sums``) summed the denominator
over a ones column first, gathered it back per edge, divided, and summed
alpha * z in a second launch. On the serving batch of ``chip_smoke.py``
(the Flickr-sized graph, GAT L=5, N=256, f_hidden=256, 4 heads, C=64,
impl="cuda", mode sg, weights from seed 0) this script:

- captures the sums' inputs of the first layer of one device step;
- holds the two forms against each other (rtol = atol = 2e-5) and each
  against a second call of itself (bitwise);
- times each form alone (CUDA events, mean of 20 launches after warm-up,
  in the order one, two, two, one);
- times the whole device step (``run_device`` and a synchronize, median of
  12) with each form, in blocks of 6 (one, two, two, one);
- times the sort kernel at every columns-a-block width at the widths the
  sums give it (1, 64 and 68 columns), beside the default
  (``sort_block_cols``).

Prints the card's name and power limit, a line a measurement, and a JSON
line; exits 1 without a card or where a check fails.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import program  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.gnn.model import GNNConfig, init_gnn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import scatter_gather as sg  # noqa: E402


def two_launch_sums(s_all, d_all, ex, z, nh):
    """The two-launch form: den = sum_e ex_e (a ones column as h), gathered
    back per edge into alpha = ex / den[dst], then sum_e alpha_e z[src_e]."""
    C, N, F = z.shape
    fh = F // nh
    e_all = s_all.shape[1]
    src = s_all.unsqueeze(1).expand(C, nh, e_all).reshape(C * nh, e_all)
    dst = d_all.unsqueeze(1).expand(C, nh, e_all).reshape(C * nh, e_all)
    src, dst = src.int().contiguous(), dst.int().contiguous()
    w = ex.float().reshape(C, e_all, nh).permute(0, 2, 1).reshape(
        C * nh, e_all).contiguous()
    ones = torch.ones((C * nh, N, 1), dtype=torch.float32, device=z.device)
    den = ops.scatter_gather_aggregate(src, dst, w, ones)
    alpha = w / torch.clamp(torch.gather(den[..., 0], 1, dst.long()),
                            min=1e-20)
    h = z.reshape(C, N, nh, fh).permute(0, 2, 1, 3).reshape(
        C * nh, N, fh).contiguous()
    out = ops.scatter_gather_aggregate(src, dst, alpha.contiguous(), h)
    return out.reshape(C, nh, N, fh).permute(0, 2, 1, 3).reshape(
        C * N, nh, fh)


def step_ms(eng, plan, reps=6) -> dict:
    """Median device-step milliseconds under each form: blocks of ``reps``
    steps in the order one, two, two, one, each block after one untimed
    step (the caching allocator settles on the form's sizes)."""
    one = program._sg_softmax_sums
    times = {"one": [], "two": []}
    try:
        for name in ("one", "two", "two", "one"):
            program._sg_softmax_sums = one if name == "one" \
                else two_launch_sums
            eng.run_device(plan)
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run_device(plan)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        program._sg_softmax_sums = one
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("sg_softmax_probe: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}", flush=True)
    graph, targets, _ = smoke.serving_batch()
    cfg = GNNConfig(kind="gat", n_layers=smoke.LAYERS, receptive_field=smoke.N,
                    f_in=smoke.F_IN, f_hidden=smoke.F_HID,
                    n_heads=smoke.HEADS)
    with DecoupledEngine(graph, cfg, params=init_gnn(cfg, seed=0,
                                                     device="cuda"),
                         config=ServingConfig(device="cuda",
                                              batch_size=smoke.C, mode="sg",
                                              impl="cuda")) as eng:
        plan = eng.plan(targets[:smoke.C])
        one = program._sg_softmax_sums
        seen = []

        def capture(*args):
            seen.append(args)
            return one(*args)

        program._sg_softmax_sums = capture
        try:
            eng.run_device(plan)
        finally:
            program._sg_softmax_sums = one
        torch.cuda.synchronize()
        args = seen[0]
        a, b = one(*args), two_launch_sums(*args)
        same = (torch.equal(a, one(*args)),
                torch.equal(b, two_launch_sums(*args)))
        err = float((a - b).abs().max())
        close = bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5))
        ms = {"one": [], "two": []}
        for name in ("one", "two", "two", "one"):
            fn = one if name == "one" else two_launch_sums
            ms[name].append(smoke.cuda_ms(lambda: fn(*args)))
        ms = {k: statistics.mean(v) for k, v in ms.items()}
        steps = step_ms(eng, plan)
    print(f"[sums] one launch vs two: max |diff| {err:.3e} (within 2e-5: "
          f"{close}); each bitwise repeatable {same} [{label}]", flush=True)
    print(f"[sums] alone: one launch {ms['one']:.4f} ms, two launches "
          f"{ms['two']:.4f} ms [{label}]", flush=True)
    print(f"[sums] gat/sg device step: one launch {steps['one']:.3f} ms, "
          f"two launches {steps['two']:.3f} ms [{label}]", flush=True)

    s_all, d_all, ex, z, nh = args
    C, N, F = z.shape
    e_all = s_all.shape[1]
    src = s_all.unsqueeze(1).expand(C, nh, e_all).reshape(
        C * nh, e_all).int().contiguous()
    dst = d_all.unsqueeze(1).expand(C, nh, e_all).reshape(
        C * nh, e_all).int().contiguous()
    w = ex.float().reshape(C, e_all, nh).permute(0, 2, 1).reshape(
        C * nh, e_all).contiguous()
    gen = torch.Generator().manual_seed(3)
    widths = {}
    for f in (1, F // nh, F // nh // 4 * 4 + 4):
        h = torch.randn(C * nh, N, f, generator=gen).cuda()
        widths[f] = {bc: smoke.cuda_ms(lambda: sg.scatter_gather_aggregate(
            src, dst, w, h, block_cols=bc))
            for bc in sg.BLOCK_COLS_CANDIDATES
            if sg.sort_block_fits(N, e_all, bc)}
        print(f"[widths] sort kernel, {C * nh} items, F={f}, E={e_all}: "
              + ", ".join(f"{bc}: {t:.4f} ms" for bc, t in widths[f].items())
              + f" (default {sg.sort_block_cols(N, e_all, f)}) [{label}]",
              flush=True)
    print(json.dumps({"card": label, "max_abs_diff": err, "sums_ms": ms,
                      "step_ms": steps, "widths_ms": widths}), flush=True)
    return 0 if close and all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
