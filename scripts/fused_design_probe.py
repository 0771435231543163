#!/usr/bin/env python3
"""Card probe: what each design choice of the fused layer's ``tf32x3``
kernel (``namespace tc`` of ``src/repro_torch/csrc/fused_gnn.cu``) is
worth, measured by undoing it.

    python3 scripts/fused_design_probe.py [--rows 0 1 2 3 4]

Builds copies of the kernel source with one choice undone each (in a
temporary directory, the repository not written, all ``nvcc`` runs
started together) and prints each copy's register and spill report for the
``tf32x3`` kernel's three forms. Then, on ``chip_smoke.py``'s serving batch
(C=64, N=256, seed-0 weights) at the five fp32 rows of
``chip_smoke.fused_rows``, it holds every copy bitwise to the kept kernel
(no choice here changes the order of any sum) and to the plain version at
2e-5, and times the copies in turns (``chip_smoke.turns``: 5 rounds, the
order reversed every other round, through the host and in a CUDA graph;
each by a direct ``ctypes`` call, ``fused_parent_probe.launch``, on the
weights split as the wrapper keeps them), one line a copy and row with its
median ratio to the kept kernel. Exits 1 when a copy does not build or
fails a check.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from fused_parent_probe import launch, typed  # noqa: E402
from repro_torch.kernels import build, fused_gnn as fg  # noqa: E402

# name -> (texts of the kernel source, what replaces each); each text
# occurs once in the source
UNDONE = {
    "kept": ((), ()),
    "two stages in ring 1": (
        ("constexpr int STAGES = 3;            // ring 1's depth",),
        ("constexpr int STAGES = 2;            // ring 1's depth",)),
    "the pipe drained every k8 step (wait 0, no split under a wgmma)": (
        ("      wgmma_wait<1>();                            // step kk - 1 "
         "done",), ("      wgmma_wait<0>();",)),
}


def build_copies(tmp: Path, edits):
    """One nvcc per copy of fused_gnn.cu with one entry of ``edits`` applied,
    all started together; {name: (library, ptxas report)}."""
    src = (build.CSRC / "fused_gnn.cu").read_text()
    procs = {}
    for i, (name, (old, new)) in enumerate(edits.items()):
        text = src
        for o, n in zip(old, new):
            if text.count(o) != 1:
                raise RuntimeError(f"{name!r}: {o!r} is not in the kernel "
                                   f"source once")
            text = text.replace(o, n)
        cu, so = tmp / f"copy{i}.cu", tmp / f"copy{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            build.nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name!r} does not build:\n{err}")
        libs[name] = (typed(ctypes.CDLL(str(so))), out + err)
    return libs


def registers(report: str) -> str:
    """The tf32x3 kernel's register and spill lines (its three forms) of an
    ``-Xptxas -v`` report, and whether ptxas serialized its wgmma
    instructions (C7518)."""
    lines = report.splitlines()
    serialized = any("C7518" in x and "tf32x3" in x for x in lines)
    out = []
    for n, line in enumerate(lines):
        if "Function properties for" in line and "tf32x3" in line:
            form = line.split("kernelI")[-1][:8]
            out.append(f"{form}: " + "; ".join(
                x.strip() for x in lines[n + 1:n + 3]))
    return " | ".join(out) + f"; wgmma serialized by ptxas: {serialized}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="+", type=int, default=[0, 1, 2, 3, 4],
                    help="indices into chip_smoke.fused_rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_design_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    _, _, sb = smoke.serving_batch()
    x = smoke.gnn_inputs(sb, torch.device("cuda"))
    rows = smoke.fused_rows(x)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_copies(Path(tmp), UNDONE)
        for name, (_, report) in libs.items():
            print(f"[registers] {name}: {registers(report)}", flush=True)
        for i in args.rows:
            tag, a, kw = rows[i]
            act = kw.get("act", "relu")
            want = fg.fused_gnn_layer_ref(*a, **kw)
            kept = launch(libs["kept"][0], a, act, split=True)
            held = {}
            for name, (lib, _) in libs.items():
                got = launch(lib, a, act, split=True)
                r = smoke.reading(got, want)[0]
                held[name] = r and bool(torch.equal(got, kept))
                ok &= held[name]
            fns = {name: (lambda lib=lib: launch(lib, a, act, split=True))
                   for name, (lib, _) in libs.items()}
            t = smoke.turns(fns, iters=200)
            med = {n: {w: statistics.median(v) for w, v in r.items()}
                   for n, r in t.items()}
            for name in fns:
                print(f"[design] {tag}, {name}: "
                      f"{'ok' if held[name] else 'FAIL'}; ms through the "
                      f"host / in a CUDA graph "
                      f"{smoke.spread(t[name]['host'])} / "
                      f"{smoke.spread(t[name]['graph'])}; / kept "
                      f"{med[name]['host'] / med['kept']['host']:.3f} / "
                      f"{med[name]['graph'] / med['kept']['graph']:.3f} "
                      f"[{label}]", flush=True)
    print(f"[design] every copy held: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
