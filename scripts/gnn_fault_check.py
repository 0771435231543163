#!/usr/bin/env python3
"""Control readings for the checks that hold the GNN kernels' CUDA code on a
GPU: ``fused_gnn_layer``, ``scatter_gather_aggregate`` and
``gat_attention``.

    python3 scripts/gnn_fault_check.py

Builds copies of ``src/repro_torch/csrc/fused_gnn.cu``,
``src/repro_torch/csrc/scatter_gather.cu`` (its sort and its bucket
kernels) and ``src/repro_torch/csrc/gat_attention.cu`` with one fault
planted in each
(in a temporary directory; the repository is not written; a fault in a
``csrc`` header is planted in a copy of the header beside the kernel's
copy, which the kernel's ``#include "..."`` finds first), and runs the
unchanged kernels and each faulty one through the checks ``chip_smoke.py``
holds them to (``fused_checks`` and ``fused_bf16_checks``, ``sg_checks``,
``sg_bucket_checks`` and ``offline_chunk_checks`` for the bucket kernel,
and ``gat_checks``), on the serving batch of the Flickr-sized graph (C=64,
N=256, Fin 512 and 256, Fout 256, E=18,688, 4 heads): every fp32 check
against the plain version at rtol = atol = 2e-5, every bf16 fused row
within one bf16 ulp of the plain version's fp32 result and its mean
signed error within 0.1 ulp, two launches bitwise equal, the fused layer
on its tf32x3 (fp32) or wgmma_bf16 kernel and GAT on its slab kernel,
block_f invariance, the fused layer's kept weight splits after an
in-place update and for a new weight at a freed weight's address, NaN
from weight-0 edges and from z rows with inf or
NaN behind a GAT weight of 0 where the plain version has it, 64 edges into
one vertex, empty, dense and all -inf GAT rows, a subnormal GAT weight;
the bucket kernel on the forced-sg batch at N=1024 (and its first 512
rows), the serving batch padded to 65,537 edge slots and the offline
build's largest chunk at F=500 and 256, each also bitwise equal to
``sg_edge_order`` (the sums one edge at a time in edge order), which is
what sees a change of order alone.

Prints each fault's prediction (written before its first run: which checks
it fails), then one line per kernel with the checks it failed. Each bucket
fault, and each fused fault of ``APART``, runs its checks in a process of
its own (``--fault <suite> <so>``): a fault that makes the kernel write or
read outside its buffers ends that process's CUDA context, and counts as
caught, as chip_smoke.py would fail (so does a process that does not end
in 600 s). ``WRAPPER_FAULTS`` swap ``fused_gnn.weight_split`` for a faulty
cache of the weight splits (no build) and run the fused suite.
Exits 1 unless the unchanged kernels pass every check and every planted
fault fails at least one; whether each fault failed exactly the predicted
checks is printed beside it. The changes in ``NOT_GATING`` (``__expf`` for ``expf``,
not a fault of the semantics; the bf16 kernel's sums over all of Fin
without fresh partials, whose error is far below a bf16 ulp) are built,
run and reported the same way, and do not decide the exit code.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build, fused_gnn as fg  # noqa: E402

FUSED_ROWS = [f"fused C=64 N=256 Fin={fin} Fout=256 {form}"
              for fin in (512, 256) for form in ("w_neigh", "+w_self")]
FUSED_SELF = ["fused C=64 N=256 Fin=256 Fout=256 self-only"]
FUSED_500 = ["fused unaligned f_in=500", "fused f_in=500 +w_self",
             "fused self-only f_in=500"]
# the kept weight splits' checks (chip_smoke.fused_split_checks)
SPLIT_UPDATE = "fused weight updated in place"
SPLIT_REUSE = "fused new weight at a freed weight's address"
SG_ROWS = [f"sg C=64 N=256 F={f} " for f in (512, 256)]
GAT_NAN = ["gat inf/NaN in z outside the structure",
           "gat inf in z behind a subnormal weight"]
# the bucket kernel's checks (sg_bucket_checks, offline_chunk_checks)
BUCKET_ROWS = ["sg bucket C="]
BUCKET_NAN = ["sg bucket N="]
CHUNK_ROWS = ["sg offline chunk C=1"]
CHUNK_NAN = ["sg offline chunk F="]
BUCKET_ALL = BUCKET_ROWS + BUCKET_NAN + CHUNK_ROWS + CHUNK_NAN
BF16 = "fused_gnn_layer "
BF16_NEIGH = [BF16 + f"C=64 N=256 Fin={fin} Fout=256 {form} bf16"
              for fin in (512, 256) for form in ("w_neigh", "+w_self")] + \
    [BF16 + f"C=5 N=100 Fin=200 Fout=256 {form} bf16"
     for form in ("w_neigh", "+w_self")]
BF16_SELF = [BF16 + f"C=64 N=256 Fin={fin} Fout=256 +w_self bf16"
             for fin in (512, 256)] + \
    [BF16 + "C=64 N=256 Fin=256 Fout=256 self-only bf16"] + \
    [BF16 + f"C=5 N=100 Fin=200 Fout=256 {form} bf16"
     for form in ("+w_self", "self-only")]
BF16_WGMMA = sorted(set(BF16_NEIGH + BF16_SELF))  # every wgmma_bf16 row

# the bf16 kernel's tile_product with its products summed into the output
# registers over all of Fin (no fresh partial, nothing added on the CUDA
# cores)
_FRESH = """  fence_regs(p[0]);
  fence_regs(p[1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      wgmma_ss_m64n64k16_tb(
          p[mt],
          desc_sw128(h_tile + (row0 + 64 * mt) * 128 + 32 * kk, 16, 1024),
          desc_sw128(w_tile + kk * 16 * 128, TILE_W, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(p[0]);
  fence_regs(p[1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] += p[mt][i];
"""
_ONE_SUM = _FRESH.split("#pragma unroll\n  for (int mt = 0; mt < 2; ++mt)\n"
                        "#pragma unroll\n    for (int i = 0;")[0] \
    .replace("p[mt],", "acc[mt],").replace("kk > 0);", "1);") \
    .replace("p[0]", "acc[0]").replace("p[1]", "acc[1]")

# name -> (kernel, the file planted in (the kernel's .cu or a csrc header),
# text of that file, what replaces it, the checks it is predicted to fail:
# each a prefix of a check's name)
FAULTS = {
    "fused: one product (1xTF32)": (
        "fused_gnn", "fused_gnn.cu",
        "  wgmma_rs_m64n64k8_tf32(acc, al, desc_sw128(b_hi, 16, 1024), "
        "!first);\n"
        "  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_lo, 16, 1024), 1);\n"
        "  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_hi, 16, 1024), 1);\n",
        "  wgmma_rs_m64n64k8_tf32(acc, ah, desc_sw128(b_hi, 16, 1024), "
        "!first);\n",
        # plain TF32 is far outside the tolerance on the CPU emulation
        # (tests/test_torch_split.py); block_f and repeats stay bitwise.
        # The wgmma_bf16 kernel's A.HW runs the same three products: where
        # a row's sum cancels, 2^-11 of its terms is more than a bf16 ulp
        FUSED_ROWS + FUSED_SELF + FUSED_500 + [SPLIT_UPDATE, SPLIT_REUSE]
        + BF16_NEIGH),
    "fused: last k-tile of A.HW skipped": (
        "fused_gnn", "fused_gnn.cu",
        "const int kt2 = NEIGH ? (N + BK - 1) / BK : 0;",
        "const int kt2 = NEIGH ? (N + BK - 1) / BK - 1 : 0;",
        # A's columns 224-255 (N=256) or 32-63 (the f_in=500 cases, N=64)
        # are real vertices in most subgraphs; the self-only rows have no A
        FUSED_ROWS + FUSED_500[:2] + [SPLIT_UPDATE, SPLIT_REUSE]),
    "fused: each k-tile's partial added twice": (
        "fused_gnn", "fused_gnn.cu",
        "    fence_frags(al[b]);\n  }\n#pragma unroll\n"
        "  for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
        "    for (int i = 0; i < 32; ++i) acc[mt][i] += p[mt][i];\n",
        "    fence_frags(al[b]);\n  }\n#pragma unroll\n"
        "  for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
        "    for (int i = 0; i < 32; ++i) acc[mt][i] += p[mt][i] + p[mt][i];\n",
        # every tf32x3 product doubles; the wgmma_bf16 kernel's A.HW runs
        # the same tile product (its H.W does not); block_f and repeats
        # stay bitwise
        FUSED_ROWS + FUSED_SELF + FUSED_500 + [SPLIT_UPDATE, SPLIT_REUSE]
        + BF16_NEIGH),
    "fused: ring 1's full wait a phase off (consumers read unfilled stages)": (
        "fused_apart", "fused_gnn.cu",
        "    mbar_wait(full1(s), (kt / STAGES) & 1);\n"
        "    const uint8_t* tile = sm + s * L::STAGE1;",
        "    mbar_wait(full1(s), (kt / STAGES + 1) & 1);\n"
        "    const uint8_t* tile = sm + s * L::STAGE1;",
        # the consumers never wait for a stage's bytes: phase 1 reads what
        # the stage held before (a race, so block_f and repeats may differ
        # too); run apart, as the bucket faults, since a block can leave
        # before its last loads land
        FUSED_ROWS + FUSED_SELF + FUSED_500 + [SPLIT_UPDATE, SPLIT_REUSE]
        + ["fused block_f 128 == 256"]),
    "sg: weight-0 repair removed": (
        "scatter_gather", "scatter_gather.cu",
        "      if (in && !live)\n",
        "      if (false)\n",
        # the finite results are bitwise the same; no NaN from padding
        ["sg weight-0 edges from inf/NaN sources"]),
    "sg: last edge of each bucket dropped": (
        "scatter_gather", "scatter_gather.cu",
        "const int b0 = start[row], b1 = start[row + 1];",
        "const int b0 = start[row], b1 = max(b0, start[row + 1] - 1);",
        # every destination with an edge loses one: 63 of 64 into vertex 3
        SG_ROWS + ["sg weight-0 edges from inf/NaN sources",
                   "sg 64 edges into one vertex"]),
    "bucket: tiles 0 and 1 take each other's cursors": (
        "bucket", "scatter_gather.cu",
        "  int* cur = base + (long long)t * B.n_out;",
        "  int* cur = base + (long long)(t < 2 && B.T > 1 ? 1 - t : t) * "
        "B.n_out;",
        # a destination in both tiles gets their edges in another order
        # (only a bitwise check sees that); one in either alone gets them
        # at the other tile's offset, over its neighbours' slots
        BUCKET_ALL),
    "bucket: the last tile's edges dropped": (
        "bucket", "scatter_gather.cu",
        "    T = E > 0 ? (E + TILE - 1) / TILE : 1;",
        "    T = E > TILE ? (E + TILE - 1) / TILE - 1 : 1;",
        # neither counted nor placed: the chunk's last tile holds ~550 real
        # edges and its weight-0 padding; the serving rows' last tiles hold
        # padding only, marked in earlier tiles too
        CHUNK_ROWS + CHUNK_NAN),
    "bucket: n_out off by one": (
        "bucket", "scatter_gather.cu",
        "  const Bucket B(N, n_out, E, F);",
        "  const Bucket B(N, n_out - 1, E, F);",
        # the last row is never written and its edges are dropped
        BUCKET_ALL),
    "bucket: a hub's last column slice skipped": (
        "bucket", "scatter_gather.cu",
        "      if (it >= items) return;\n",
        "      if (it >= items) return;\n"
        "      if (it % slices == slices - 1) continue;\n",
        # the tail columns of a row with HUB live edges or more are never
        # written: the chunk's hubs (14,266 and 9,990 edges, and nine more
        # over 512)
        CHUNK_ROWS + CHUNK_NAN),
    "bucket: weight-0 marks of tile 0 only": (
        "bucket", "scatter_gather.cu",
        "    for (int t = lane; t < B.T; t += 32) m |= mark[(long long)t * "
        "B.NW + wd];",
        "    for (int t = lane; t < 1; t += 32) m |= mark[(long long)t * "
        "B.NW + wd];",
        # the padding (weight 0, from the inf/NaN row) sits past tile 0
        BUCKET_NAN + CHUNK_NAN),
    "gat: NaN from z rows outside the structure dropped": (
        "gat_attention", "gat_attention.cu",
        "    if (any_bad) {",
        "    if (false) {",
        # the first CUDA kernel's skip of the entries outside the
        # structure: finite where the oracle's 0 * inf is NaN; finite
        # inputs bitwise the same
        GAT_NAN),
    "gat: zero weights skipped in the list walk": (
        "gat_attention", "gat_attention.cu",
        "          fma4(acc, __int_as_float(e[u].y), zv[u]);",
        "          if (e[u].y != 0) fma4(acc, __int_as_float(e[u].y), zv[u]);",
        # only the structural weight that underflows to 0 (in front of an
        # inf) tells; a subnormal weight is not 0 and stays
        GAT_NAN[:1]),
    "gat: each row's last list entry dropped": (
        "gat_attention", "gat_attention.cu",
        "      if (n + lane < np) lst[n + lane] = make_int2(N * q4, 0);",
        "      if (n - 1 + lane < np) lst[n - 1 + lane] = make_int2(N * q4, 0);",
        # every non-empty slab row loses an entry (the row kernel at N=320
        # and the rows that are 0 or NaN whatever their last entry pass)
        ["gat C=64 N=256", "gat C=8 N=200",
         "gat empty, dense and all -inf rows", "gat rows sum to one"]
        + GAT_NAN),
    "gat: max seeded at -inf": (
        "gat_attention", "gat_attention.cu",
        "      if (n < N) m = fmaxf(m, NEG_BIG);",
        "",
        # only a row whose structural scores are all -inf has no finite
        # max: exp(-inf - -inf) is NaN where the oracle gives 0
        ["gat empty, dense and all -inf rows",
         "gat empty and all -inf rows are 0"]),
    "fused bf16: W read without the transpose bit": (
        "fused_gnn", "hopper.cuh",
        "%33, p, 1, 1, 0, 1;",
        "%33, p, 1, 1, 0, 0;",
        # H.W reads W^T's tiles as W's: every wgmma_bf16 row is wrong
        BF16_WGMMA),
    "fused bf16: the last k-tile of H.Ws skipped": (
        "fused_gnn", "fused_gnn.cu",
        "    if (SELF) tile_product(st, st + TILE_H + TILE_W, 128 * cw, p, as);",
        "    if (SELF && kt + 1 < kt1)\n"
        "      tile_product(st, st + TILE_H + TILE_W, 128 * cw, p, as);",
        # the rows with a self weight lose Fin's last 64 (or 8) columns
        BF16_SELF),
    "fused bf16: truncating store": (
        "fused_gnn", "elem.cuh",
        "    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);\n"
        "    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);",
        "    const __nv_bfloat162 a = __halves2bfloat162(\n"
        "        __float2bfloat16_rz(x[0]), __float2bfloat16_rz(x[1]));\n"
        "    const __nv_bfloat162 b = __halves2bfloat162(\n"
        "        __float2bfloat16_rz(x[2]), __float2bfloat16_rz(x[3]));",
        # within one ulp of the fp32 result, but about -0.5 ulp on average:
        # the wgmma_bf16 rows (16-byte stores); cuda_core stores one
        # element at a time and keeps rounding to nearest
        BF16_WGMMA),
    "fused bf16: one sum over all of Fin, no fresh partials": (
        "fused_gnn", "fused_gnn.cu", _FRESH, _ONE_SUM,
        # the tensor cores' truncated sums over 512 products stay ~2^-14 of
        # the result, far inside a bf16 ulp: no check sees it
        []),
    "gat: __expf for expf": (
        "gat_attention", "gat_attention.cu",
        "{ return expf(v); }",
        "{ return __expf(v); }",
        # the fast exp flushes the subnormal weight e^-95 to 0, so its inf
        # in z gives NaN where the oracle's inf * e^-95 is inf
        ["gat inf in z behind a subnormal weight"]),
}
# Reported beside their prediction; they do not decide the exit code.
NOT_GATING = {"gat: __expf for expf",
              "fused bf16: one sum over all of Fin, no fresh partials"}


# the library each suite of checks holds (the bucket kernel's own checks
# hold scatter_gather.cu's bucket code; "fused_apart" is the fused suite
# run in a process of its own)
LIBRARY = {"bucket": "scatter_gather", "fused_apart": "fused_gnn"}
APART = ("bucket", "fused_apart")


def _keep_without_version():
    """A weight-split cache that ignores ``_version``: an in-place update is
    served the split of the old values."""
    from repro_torch.kernels import fused_gnn as fg
    kept = {}

    def split(w, stream=None):
        base = w if w._base is None else w._base
        key = (id(base), w.data_ptr(), tuple(w.shape))
        if key not in kept:
            kept[key] = (base, fg.tf32_split(w))
        return kept[key][1]
    return split


def _keep_by_address():
    """A weight-split cache keyed by address, shape and ``_version`` with no
    reference to the tensor: a new weight at a freed weight's address, at
    the same ``_version``, is served the freed weight's split."""
    from repro_torch.kernels import fused_gnn as fg
    kept = {}

    def split(w, stream=None):
        key = (w.data_ptr(), tuple(w.shape), w._version)
        if key not in kept:
            kept[key] = fg.tf32_split(w)
        return kept[key]
    return split


# faults of the fused wrapper's weight-split cache: name -> (the
# replacement of fused_gnn.weight_split, the checks predicted to fail)
WRAPPER_FAULTS = {
    "fused wrapper: a stale split served after an in-place update": (
        _keep_without_version, [SPLIT_UPDATE]),
    "fused wrapper: splits keyed by address, shape and _version": (
        _keep_by_address, [SPLIT_REUSE]),
}


def build_faults(tmp: Path):
    """One nvcc per faulty copy, all started together; {name: CDLL}. Each
    copy gets a directory of its own, with the edited header beside the
    kernel's source where the fault lies in a header."""
    procs = {}
    for i, (name, (suite, path, old, new, _)) in enumerate(FAULTS.items()):
        kernel = LIBRARY.get(suite, suite)
        src = (build.CSRC / path).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name!r}: {old!r} is not in {path} "
                               f"once")
        here = tmp / f"fault{i}"
        here.mkdir()
        (here / path).write_text(src.replace(old, new))
        cu, so = here / f"{kernel}.cu", here / f"{kernel}.so"
        if path != cu.name:
            cu.write_text((build.CSRC / cu.name).read_text())
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


def bucket_setup(dev):
    """The bucket suite's inputs and its checks, as a function of x."""
    graph, targets, sb = smoke.serving_batch()
    x = smoke.gnn_inputs(sb, dev)
    big = smoke.big_batch(graph, targets)
    chunk = smoke.offline_chunk(graph)
    return x, lambda x: (smoke.sg_bucket_checks(x, big, dev)
                         + smoke.offline_chunk_checks(graph, chunk)[0])


def fused_suite(x):
    return smoke.fused_checks(x) + smoke.fused_bf16_checks(x)


def fault_apart(suite: str, so: str) -> int:
    """One faulty library's checks of ``suite`` (bucket or fused_apart), in
    a process of its own (a fault that writes or reads outside its buffers
    ends the process's CUDA context): prints them as one JSON line."""
    x, bucket = bucket_setup(torch.device("cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    build._libs[LIBRARY[suite]] = ctypes.CDLL(so)
    got = (bucket if suite == "bucket" else fused_suite)(x)
    print(json.dumps([[n, bool(ok), text] for n, ok, text in got]),
          flush=True)
    return 0


def checks_apart(suite: str, so: Path, timeout: float = 600.0):
    """``fault_apart`` in a subprocess: its checks, or a failing check
    "CUDA fault" where the process ended without them or did not end in
    ``timeout`` seconds (chip_smoke.py would fail there too)."""
    try:
        p = subprocess.run([sys.executable, __file__, "--fault", suite,
                            str(so)], capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return [("CUDA fault", False, f"the checks' process did not end in "
                                      f"{timeout:.0f} s")]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[[")]
    if p.returncode == 0 and lines:
        return [tuple(c) for c in json.loads(lines[-1])]
    tail = (p.stderr.strip().splitlines() or ["no output"])[-1]
    return [("CUDA fault", False, f"the checks' process ended with exit "
                                  f"code {p.returncode}: {tail}")]


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--fault":
        return fault_apart(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("gnn_fault_check: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (*_, predicted) in {**FAULTS, **WRAPPER_FAULTS}.items():
        print(f"[predicted] {name}: fails {predicted}", flush=True)
    x, bucket = bucket_setup(torch.device("cuda"))
    run = {"fused_gnn": fused_suite,
           "scatter_gather": smoke.sg_checks,
           "bucket": bucket,
           "gat_attention": smoke.gat_checks}
    good = {k: build.load(LIBRARY.get(k, k)) for k in run}
    with tempfile.TemporaryDirectory() as tmp:
        faults = build_faults(Path(tmp))
        clean = {k: failed(run[k](x), k, label, "unchanged kernel")
                 for k in run}
        caught, as_predicted = {}, {}
        for name, lib in [*faults.items(), *WRAPPER_FAULTS.items()]:
            if name in WRAPPER_FAULTS:
                suite, (make, predicted) = "fused_gnn", WRAPPER_FAULTS[name]
                kept = fg.weight_split
                fg.weight_split = make()
                try:
                    checks = run[suite](x)
                finally:
                    fg.weight_split = kept
            elif FAULTS[name][0] in APART:
                suite, *_, predicted = FAULTS[name]
                checks = checks_apart(suite, Path(lib._name))
            else:
                suite, *_, predicted = FAULTS[name]
                kernel = LIBRARY.get(suite, suite)
                build._libs[kernel] = lib
                try:
                    checks = run[suite](x)
                finally:
                    build._libs[kernel] = good[suite]
            bad = failed(checks, suite, label, name)
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
