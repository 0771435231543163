#!/usr/bin/env python3
"""Card probe: what each design choice of the D=128 wgmma flash kernel
(``namespace w128`` of ``src/repro_torch/csrc/flash_attention.cu``) is
worth, measured by undoing it.

    python3 scripts/flash_design_probe.py [--shapes phi3 pixtral Jamba]

Builds copies of the kernel source with one choice undone each
(``flash_fault_check.build_faults``: in a temporary directory, the
repository not written, all ``nvcc`` runs started together), and prints each copy's register and spill report for
the D=128 kernel. Then, at phi3's (B=1, H=40, 10 KV heads, S=8192, D=128,
causal), pixtral's (H=32, 8 KV heads) and Jamba's (H=64, 8 KV heads)
prefill shapes on bf16 inputs seeded on the card, it holds every copy to
``flash_bf16_check`` (the check ``chip_smoke.py`` applies) and times the
copies and ``scaled_dot_product_attention(enable_gqa=True)`` in turns
(``chip_smoke.turns``: 5 rounds, the order reversed every other round,
through the host and in a CUDA graph; each kernel by a direct ``ctypes``
call, ``flash_fault_check.launch``), one line a copy and shape with its median ratio to the kept
kernel and to SDPA. Exits 1 when a copy does not build or fails the
check.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from flash_fault_check import build_faults, launch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _parts, flash_bf16_check, flash_bf16_tol)

SHAPES = {  # name: B, H, Kh, S
    "phi3": (1, 40, 10, 8192),
    "pixtral": (1, 32, 8, 8192),
    "Jamba": (1, 64, 8, 8192),
}

QBUF = "constexpr int QBUF = {};                        // Q buffers"
STAGES = "constexpr int STAGES = {};                      // K/V ring depth"
# name -> (texts of the kernel source, what replaces each); each text
# occurs once in the source
UNDONE = {
    "kept": ((), ()),
    "no turns (the two consumers issue their GEMMs unordered)": (
        ("const bool turns = w.q0 + 64 < Sq;",),
        ("const bool turns = false;",)),
    "no overlap inside a warpgroup (P.V waited with Q.K^T)": (
        ("wgmma_wait<1>();                            // S_j done, P.V in "
         "flight",), ("wgmma_wait<0>();",)),
    "a block per item (no persistent grid)": (
        ("const int grid = sms < n_items ? sms : n_items;",),
        ("const int grid = n_items;",)),
    "the walk without the snake (item r * grid + block)": (
        ("const int i = r * grid + ((r & 1) ? grid - 1 - block : block);",),
        ("const int i = r * grid + block;",)),
    "one Q buffer, two stages": ((QBUF.format(2),), (QBUF.format(1),)),
    "one Q buffer, three stages": (
        (QBUF.format(2), STAGES.format(2)),
        (QBUF.format(1), STAGES.format(3))),
}


def registers(report: str) -> str:
    """The D=128 kernel's lines of an ``-Xptxas -v`` report, and whether
    ptxas serialized its wgmma instructions (C7518: a wgmma or its
    registers on a divergent path; every wgmma then waits for the last)."""
    lines = report.splitlines()
    serialized = any("C7518" in x and "wgmma128" in x for x in lines)
    for n, line in enumerate(lines):
        if "Function properties for" in line and "wgmma128" in line:
            return ("; ".join(x.strip() for x in lines[n + 1:n + 3])
                    + f"; wgmma serialized by ptxas: {serialized}")
    return "(not in the report)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_design_probe: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_faults(Path(tmp), UNDONE)
        for name, (_, report) in libs.items():
            print(f"[registers] {name}: {registers(report)}", flush=True)
        for shape in args.shapes:
            B, H, KH, S = SHAPES[shape]
            gen = torch.Generator(device="cuda").manual_seed(S + H)
            q, k, v = (torch.randn(s, generator=gen, device="cuda")
                       .to(torch.bfloat16)
                       for s in ((B, H, S, 128), (B, KH, S, 128),
                                 (B, KH, S, 128)))
            kg, vg = (t.repeat_interleave(H // KH, dim=1) for t in (k, v))
            p, den, vf = _parts(q, kg, vg, True)
            want = torch.einsum("bhqk,bhkd->bhqd", p, vf).div_(den)
            del p, den, vf
            tol = flash_bf16_tol(q, kg, vg, causal=True)
            del kg, vg
            held = {}
            for name, (lib, _) in libs.items():
                r = flash_bf16_check(launch(lib, q, k, v),
                                     launch(lib, q, k, v), want, tol)
                held[name] = r["ok"]
                ok &= r["ok"]
            del want, tol
            fns = {name: (lambda lib=lib: launch(lib, q, k, v))
                   for name, (lib, _) in libs.items()}
            fns["sdpa"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=KH < H)
            t = smoke.turns(fns)
            med = {n: {w: statistics.median(x) for w, x in r.items()}
                   for n, r in t.items()}
            for name in fns:
                verdict = ("" if name == "sdpa" else
                           f"flash_bf16_check {'ok' if held[name] else 'FAIL'}; ")
                print(f"[design] {shape} B={B} H={H} Kh={KH} S={S} D=128 "
                      f"causal, {name}: {verdict}ms through the host / in a "
                      f"CUDA graph {smoke.spread(t[name]['host'])} / "
                      f"{smoke.spread(t[name]['graph'])}; / kept "
                      f"{med[name]['host'] / med['kept']['host']:.3f} / "
                      f"{med[name]['graph'] / med['kept']['graph']:.3f}; / "
                      f"SDPA {med[name]['host'] / med['sdpa']['host']:.3f} / "
                      f"{med[name]['graph'] / med['sdpa']['graph']:.3f} "
                      f"[{label}]", flush=True)
            del q, k, v
    print(f"[design] every copy held: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
