#!/usr/bin/env python3
"""Control readings for the checks that hold the GNN kernels' CUDA code on a
GPU: ``fused_gnn_layer``, ``scatter_gather_aggregate`` and
``gat_attention``.

    python3 scripts/gnn_fault_check.py

Builds copies of ``src/repro_torch/csrc/fused_gnn.cu``,
``src/repro_torch/csrc/scatter_gather.cu`` and
``src/repro_torch/csrc/gat_attention.cu`` with one fault planted in each
(in a temporary directory; the repository is not written), and runs the
unchanged kernels and each faulty one through the checks ``chip_smoke.py``
holds them to (``fused_checks``, ``sg_checks`` and ``gat_checks``), on the
serving batch of the Flickr-sized graph (C=64, N=256, Fin 512 and 256,
Fout 256, E=18,688, 4 heads): every check against the plain version at
rtol = atol = 2e-5, two launches bitwise equal, the fused layer on its
tf32x3 kernel and GAT on its slab kernel, block_f invariance, NaN from
weight-0 edges and from z rows with inf or NaN behind a GAT weight of 0
where the plain version has it, 64 edges into one vertex, empty, dense and
all -inf GAT rows, a subnormal GAT weight.

Prints each fault's prediction (written before its first run: which checks
it fails), then one line per kernel with the checks it failed. Exits 1
unless the unchanged kernels pass every check and every planted fault fails
at least one; whether each fault failed exactly the predicted checks is
printed beside it. A change in ``NOT_GATING`` (``__expf`` for ``expf``, not
a fault of the semantics) is built, run and reported the same way, and does
not decide the exit code.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

FUSED_ROWS = [f"fused C=64 N=256 Fin={fin} Fout=256 {form}"
              for fin in (512, 256) for form in ("w_neigh", "+w_self")]
SG_ROWS = [f"sg C=64 N=256 F={f} " for f in (512, 256)]
GAT_NAN = ["gat inf/NaN in z outside the structure",
           "gat inf in z behind a subnormal weight"]

# name -> (kernel, text of its source, what replaces it, the checks it is
# predicted to fail: each a prefix of a check's name)
FAULTS = {
    "fused: one product (1xTF32)": (
        "fused_gnn",
        "  wgmma_rs_m64n64k8_tf32(acc, al, desc_sw128(b_hi, 16, 1024), "
        "!first);\n"
        "  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_lo, 16, 1024), 1);\n"
        "  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_hi, 16, 1024), 1);\n",
        "  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_hi, 16, 1024), "
        "!first);\n",
        # plain TF32 is far outside the tolerance on the CPU emulation
        # (tests/test_torch_split.py); block_f and repeats stay bitwise
        FUSED_ROWS + ["fused C=64 N=256 Fin=256 Fout=256 self-only",
                      "fused unaligned f_in=500", "fused f_in=500 +w_self",
                      "fused self-only f_in=500"]),
    "fused: last k-tile of A.HW skipped": (
        "fused_gnn",
        "const int kt2 = NEIGH ? (N + BK - 1) / BK : 0;",
        "const int kt2 = NEIGH ? (N + BK - 1) / BK - 1 : 0;",
        # A's columns 224-255 (N=256) or 32-63 (the f_in=500 cases, N=64)
        # are real vertices in most subgraphs; the self-only rows have no A
        FUSED_ROWS + ["fused unaligned f_in=500", "fused f_in=500 +w_self"]),
    "sg: weight-0 repair removed": (
        "scatter_gather",
        "      if (in && !live)\n",
        "      if (false)\n",
        # the finite results are bitwise the same; no NaN from padding
        ["sg weight-0 edges from inf/NaN sources"]),
    "sg: last edge of each bucket dropped": (
        "scatter_gather",
        "const int b0 = start[row], b1 = start[row + 1];",
        "const int b0 = start[row], b1 = max(b0, start[row + 1] - 1);",
        # every destination with an edge loses one: 63 of 64 into vertex 3
        SG_ROWS + ["sg weight-0 edges from inf/NaN sources",
                   "sg 64 edges into one vertex"]),
    "gat: NaN from z rows outside the structure dropped": (
        "gat_attention",
        "    if (any_bad) {",
        "    if (false) {",
        # the first CUDA kernel's skip of the entries outside the
        # structure: finite where the oracle's 0 * inf is NaN; finite
        # inputs bitwise the same
        GAT_NAN),
    "gat: zero weights skipped in the list walk": (
        "gat_attention",
        "          fma4(acc, __int_as_float(e[u].y), zv[u]);",
        "          if (e[u].y != 0) fma4(acc, __int_as_float(e[u].y), zv[u]);",
        # only the structural weight that underflows to 0 (in front of an
        # inf) tells; a subnormal weight is not 0 and stays
        GAT_NAN[:1]),
    "gat: each row's last list entry dropped": (
        "gat_attention",
        "      if (n + lane < np) lst[n + lane] = make_int2(N * q4, 0);",
        "      if (n - 1 + lane < np) lst[n - 1 + lane] = make_int2(N * q4, 0);",
        # every non-empty slab row loses an entry (the row kernel at N=320
        # and the rows that are 0 or NaN whatever their last entry pass)
        ["gat C=64 N=256", "gat C=8 N=200",
         "gat empty, dense and all -inf rows", "gat rows sum to one"]
        + GAT_NAN),
    "gat: max seeded at -inf": (
        "gat_attention",
        "      if (n < N) m = fmaxf(m, NEG_BIG);",
        "",
        # only a row whose structural scores are all -inf has no finite
        # max: exp(-inf - -inf) is NaN where the oracle gives 0
        ["gat empty, dense and all -inf rows",
         "gat empty and all -inf rows are 0"]),
    "gat: __expf for expf": (
        "gat_attention",
        "{ return expf(v); }",
        "{ return __expf(v); }",
        # the fast exp flushes the subnormal weight e^-95 to 0, so its inf
        # in z gives NaN where the oracle's inf * e^-95 is inf
        ["gat inf in z behind a subnormal weight"]),
}
# Reported beside their prediction; they do not decide the exit code.
NOT_GATING = {"gat: __expf for expf"}


def build_faults(tmp: Path):
    """One nvcc per faulty copy, all started together; {name: CDLL}."""
    procs = {}
    for i, (name, (kernel, old, new, _)) in enumerate(FAULTS.items()):
        src = (build.CSRC / f"{kernel}.cu").read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name!r}: {old!r} is not in "
                               f"{kernel}.cu once")
        src = src.replace(old, new)
        cu, so = tmp / f"fault{i}.cu", tmp / f"fault{i}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            build.nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"fault {name!r} does not build:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def failed(checks, kernel: str, label: str, name: str):
    """Prints one line per failing check; returns their names."""
    bad = sorted(n for n, ok, _ in checks if not ok)
    for n, ok, text in checks:
        if not ok:
            print(f"[{kernel}] {name}: FAILS {n}: {text}", flush=True)
    print(f"[{kernel}] {name}: {len(checks) - len(bad)} of {len(checks)} "
          f"checks pass [{label}]", flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("gnn_fault_check: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (_, _, _, predicted) in FAULTS.items():
        print(f"[predicted] {name}: fails {predicted}", flush=True)
    run = {"fused_gnn": smoke.fused_checks, "scatter_gather": smoke.sg_checks,
           "gat_attention": smoke.gat_checks}
    good = {k: build.load(k) for k in run}
    _, _, sb = smoke.serving_batch()
    x = smoke.gnn_inputs(sb, torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        faults = build_faults(Path(tmp))
        clean = {k: failed(run[k](x), k, label, "unchanged kernel")
                 for k in run}
        caught, as_predicted = {}, {}
        for name, lib in faults.items():
            kernel, _, _, predicted = FAULTS[name]
            build._libs[kernel] = lib
            try:
                checks = run[kernel](x)
            finally:
                build._libs[kernel] = good[kernel]
            bad = failed(checks, kernel, label, name)
            expected = bad == sorted(
                n for n, _, _ in checks
                if any(n.startswith(p) for p in predicted))
            caught[name], as_predicted[name] = bool(bad), expected
            gates = "" if name not in NOT_GATING else \
                " (does not decide the exit code)"
            print(f"[fault] {name}: {'caught' if bad else 'NOT CAUGHT'}, "
                  f"failed checks as predicted: {expected}{gates}",
                  flush=True)
    ok = not any(clean.values()) and all(
        v for n, v in caught.items() if n not in NOT_GATING)
    print(f"[summary] unchanged kernels pass every check: "
          f"{not any(clean.values())}; faults caught: "
          f"{sum(caught.values())} of {len(caught)}; failing exactly the "
          f"predicted checks: {sum(as_predicted.values())} of "
          f"{len(as_predicted)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
