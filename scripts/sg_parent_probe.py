#!/usr/bin/env python3
"""Card probe: the scatter-gather's ``bucket`` kernel of this tree against
an earlier commit's, on the same inputs, and the offline tier build
through each tree's port.

    python3 scripts/sg_parent_probe.py --extract [--rev HEAD~1]  # in git
    python3 scripts/sg_parent_probe.py [--no-builds]             # on a GPU

``--extract`` writes the earlier commit's ``src/repro_torch`` (``git
archive``; its ``csrc/scatter_gather.cu`` and the headers it includes
among them) to ``build/sg_parent/`` (which ``.gitignore`` covers) with the
revision's hash beside it, and exits; the machine with the card need not
hold the repository's history. The earlier kernel's C entry is the one
without ``n_out``: it writes all N rows.

Without it, on the card:

1. Builds the earlier ``scatter_gather.cu`` with this tree's nvcc flags
   and runs both bucket kernels on the same inputs at the five ``bucket``
   rows of ``chip_smoke.py`` (the offline build's largest chunk, C=1,
   2048 destinations of N=32,868 source rows, at F=500 and F=256; forced
   sg at C=8 N=1024 F=256 in fp32 and in bf16; the serving batch padded to
   E=65,537 at C=64 N=256 F=256) and two weight-0 probes (inf and NaN on
   the source row of the padding edges: the N=1024 batch's and the
   chunk's row 0). This tree's kernel returns the chunk's n_out=2048 rows,
   the earlier one all N, cut to those. Each pair must be bitwise equal
   with NaN in the same places, and two launches of this tree's kernel
   bitwise equal. Times both in turns (``chip_smoke.turns``: earlier /
   this / this / earlier, 5 rounds, through the host and in a CUDA graph;
   the earlier kernel by a direct ``ctypes`` call, this tree's through
   ``scatter_gather_aggregate``), beside ``index_add_`` into the same
   n_out rows and the bound with N and with n_out output rows.
2. Unless ``--no-builds``: one process a turn, earlier / this / this /
   earlier, each importing one tree's port: the wrapper's host time a
   call (``chip_smoke.host_us``'s loop) at the serving ``sort`` shape
   (C=64 N=256 E=18,688 F=512) and at the chunk, then the offline tier
   build (``layer_major_embeddings``, chunk 2048) of a gcn and a sage
   model (chip_smoke's widths, readout="target", seed-0 weights) on the
   Flickr-sized graph under impl="cuda" (timed after one warm build) and
   impl="torch". The cuda builds of the two trees must be bitwise equal.

Prints one line a row and a turn, and exits 1 unless every check holds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "sg_parent"
KINDS = ("gcn", "sage")
SORT_SHAPE = (64, 256, 18688, 512)      # C, N, E, F: the serving sort launch


def extract(rev: str) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    tar = subprocess.run(["git", "archive", rev, "src/repro_torch"],
                         cwd=ROOT, check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", str(OUT)], input=tar, check=True)
    sha = subprocess.run(["git", "rev-parse", rev], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    (OUT / "REV").write_text(sha + "\n")
    print(f"extracted src/repro_torch of {sha} to {OUT}")


def parent_library(so_dir: Path):
    """The earlier scatter_gather.cu built with this tree's flags."""
    from repro_torch.kernels import build
    cu = OUT / "src" / "repro_torch" / "csrc" / "scatter_gather.cu"
    so = so_dir / "scatter_gather_parent.so"
    p = subprocess.run(build.nvcc_command(cu, so), capture_output=True,
                       text=True)
    if p.returncode:
        raise SystemExit(f"sg_parent_probe: the earlier kernel does not "
                         f"build:\n{p.stderr}")
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"scatter_gather_bucket_{dt}")
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
        fn.restype = i
    lib.scatter_gather_bucket_scratch_words.argtypes = [i, i, i, i]
    lib.scatter_gather_bucket_scratch_words.restype = ctypes.c_longlong
    return lib


def parent_bucket(lib, src, dst, w, h, n_out):
    """The earlier bucket kernel: all N rows, cut to the first n_out."""
    import torch
    C, E = src.shape
    _, N, F = h.shape
    out = torch.empty_like(h)
    scratch = torch.empty(lib.scatter_gather_bucket_scratch_words(C, N, E, F),
                          dtype=torch.int32, device=h.device)
    dt = "f32" if h.dtype == torch.float32 else "bf16"
    err = getattr(lib, f"scatter_gather_bucket_{dt}")(
        src.data_ptr(), dst.data_ptr(), w.data_ptr(), h.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), C, N, E, F,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier bucket kernel failed ({err})")
    return out[:, :n_out]


def rows(smoke, dev):
    """(tag, (src, dst, w, h), n_out) of the five bucket rows and the two
    weight-0 probes."""
    import torch
    graph, targets, sb = smoke.serving_batch()
    x = smoke.gnn_inputs(sb, dev)
    big = smoke.big_batch(graph, targets)
    wide = smoke.sg_wide_rows(x, big, dev)
    local, i, _ = smoke.offline_chunk(graph)
    gen = torch.Generator().manual_seed(0)
    out = []
    for f in (smoke.F_IN, smoke.F_HID):
        H = torch.randn(graph.num_vertices, f, generator=gen).to(dev)
        args = smoke.chunk_args(local, i, H)
        out.append((f"offline chunk C=1 N={args[3].shape[1]} n_out="
                    f"{local.chunk} F={f} E={local.e_cap}", args,
                    local.chunk))
        if f == smoke.F_IN:
            Hn = H.clone()
            Hn[0, 7] = float("inf")
            Hn[0, f - 1] = float("nan")
            probe = (f"offline chunk F={f}, inf/NaN on row 0 (the padding's "
                     f"source)", smoke.chunk_args(local, i, Hn), local.chunk)
    n_big = wide[1][1][3].shape[1]
    out.append((wide[1][0] + " fp32", wide[1][1], n_big))
    src, dst, w, h = wide[1][1]
    out.append((wide[1][0] + " bf16", (src, dst, w, h.to(torch.bfloat16)),
                n_big))
    out.append((wide[0][0], wide[0][1], smoke.N))
    h = h.clone()
    h[0, n_big - 1, 1] = float("inf")
    h[3, n_big - 1, 7] = float("nan")
    h[5, n_big - 1, 200] = float("-inf")
    out.append((f"C={smoke.BIG_C} N={n_big} F={smoke.F_HID}, inf/NaN on "
                f"the padding's source", (src, dst, w, h), n_big))
    out.append(probe)
    return out


def kernel_rows(label) -> bool:
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import scatter_gather as sg
    dev = torch.device("cuda")
    rev = (OUT / "REV").read_text().strip()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; earlier kernel from {rev}", flush=True)
    old = parent_library(OUT)
    ok = True
    for tag, args, n_out in rows(smoke, dev):
        check(sg.sg_variant(args[3].shape[1], args[0].shape[1]) == "bucket",
              tag)
        before = sg.variant_launches["bucket"]
        got = sg.scatter_gather_aggregate(*args, n_out=n_out)
        again = sg.scatter_gather_aggregate(*args, n_out=n_out)
        was = parent_bucket(old, *args, n_out)
        torch.cuda.synchronize()
        check(sg.variant_launches["bucket"] == before + 2, tag)
        equal = smoke.same_bits(got, was)
        repeat = smoke.same_bits(got, again)
        held = equal and repeat and got.shape == was.shape
        ok &= held
        nan = int(torch.isnan(got).sum())
        t = smoke.turns({
            "earlier": lambda: parent_bucket(old, *args, n_out),
            "this": lambda: sg.scatter_gather_aggregate(*args, n_out=n_out),
            "index_add_": smoke.sg_library(args, n_out)})
        bnd = smoke.sg_bound(args, n_out)[0]
        bnd_n = smoke.sg_bound(args)[0]
        med = {k: (statistics.median(v["host"]), statistics.median(v["graph"]))
               for k, v in t.items()}
        print(f"[parent] {tag}: bitwise equal to the earlier kernel {equal} "
              f"(NaN {nan}), two launches bitwise {repeat}; ms in turns, "
              f"host / graph, median [min-max] of 5: earlier "
              f"{smoke.spread(t['earlier']['host'])} / "
              f"{smoke.spread(t['earlier']['graph'])}, this "
              f"{smoke.spread(t['this']['host'])} / "
              f"{smoke.spread(t['this']['graph'])}, index_add_ into "
              f"{n_out} rows {smoke.spread(t['index_add_']['host'])} / "
              f"{smoke.spread(t['index_add_']['graph'])}; this / earlier "
              f"{med['this'][0] / med['earlier'][0]:.3f} / "
              f"{med['this'][1] / med['earlier'][1]:.3f}, this / index_add_ "
              f"{med['this'][0] / med['index_add_'][0]:.3f} / "
              f"{med['this'][1] / med['index_add_'][1]:.3f}; bound "
              f"{bnd:.4f} ms ({n_out} output rows), {bnd_n:.4f} ms "
              f"({args[3].shape[1]} rows) {'ok' if held else 'FAIL'} "
              f"[{label}]", flush=True)
    return ok


def turn(tree: Path, out: Path) -> None:
    """One tree's host times and tier builds, in this process (its port
    first on the path); writes the cuda builds' rows and the times."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.core.program import lower, specialize
    from repro_torch.gnn.model import GNNConfig, init_gnn
    from repro_torch.graphs.synthetic import get_graph
    from repro_torch.kernels import build, scatter_gather as sg
    from repro_torch.precompute import layer_major_embeddings
    from repro_torch.precompute.propagate import _LocalCSR
    assert Path(sg.__file__).is_relative_to(tree), sg.__file__
    build.build(["scatter_gather"])
    dev = torch.device("cuda")
    graph = get_graph("flickr", scale=1.0)

    def host_us(fn, calls=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    gen = torch.Generator().manual_seed(0)
    C, N, E, F = SORT_SHAPE
    sort_args = (torch.randint(0, N, (C, E), generator=gen,
                               dtype=torch.int32).to(dev),
                 torch.randint(0, N, (C, E), generator=gen,
                               dtype=torch.int32).to(dev),
                 torch.randn(C, E, generator=gen).to(dev),
                 torch.randn(C, N, F, generator=gen).to(dev))
    local = _LocalCSR(graph, np.arange(graph.num_vertices), 2048, "cuda",
                      dev)
    rows_, src, dst, nrows = local._chunks[0]
    h = torch.randn(1, nrows, 500, generator=gen).to(dev)
    w = local._weights("gcn")[0]
    res = {"sort_host_us": host_us(
        lambda: sg.scatter_gather_aggregate(*sort_args)),
        "chunk_host_us": host_us(
        lambda: sg.scatter_gather_aggregate(src, dst, w, h))}
    for kind in KINDS:
        cfg = GNNConfig(kind=kind, n_layers=5, receptive_field=256,
                        f_in=graph.feature_dim, f_hidden=256, n_heads=4,
                        readout="target")
        prog, _ = specialize(lower(cfg), n=256, f_in=graph.feature_dim)
        params = init_gnn(cfg, seed=0, device="cuda")
        times = {}
        for impl in ("cuda", "cuda", "torch"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb = layer_major_embeddings(graph, prog, params,
                                         chunk_size=2048, impl=impl,
                                         device="cuda")
            torch.cuda.synchronize()
            times[impl] = time.perf_counter() - t0
            if impl == "cuda":
                np.save(out / f"{kind}.npy", emb)
        res[kind] = times
    (out / "times.json").write_text(json.dumps(res))


def builds(label) -> bool:
    import numpy as np
    trees = {"earlier": OUT, "this": ROOT}
    order = ("earlier", "this", "this", "earlier")
    runs = []
    for k, name in enumerate(order):
        out = OUT / f"turn{k}"
        out.mkdir(parents=True, exist_ok=True)
        p = subprocess.run([sys.executable, __file__, "--turn",
                            str(trees[name]), "--out", str(out)],
                           capture_output=True, text=True)
        if p.returncode:
            print(p.stdout + p.stderr, file=sys.stderr)
            raise SystemExit(f"sg_parent_probe: turn {k} ({name}) failed")
        res = json.loads((out / "times.json").read_text())
        runs.append((name, out, res))
        print(f"[parent] turn {k} ({name}): wrapper host us a call at the "
              f"serving sort shape {res['sort_host_us']:.2f}, at the chunk "
              f"{res['chunk_host_us']:.2f}; tier build s, impl=cuda / "
              f"impl=torch: " + ", ".join(
                  f"{kind} {res[kind]['cuda']:.3f} / {res[kind]['torch']:.3f}"
                  for kind in KINDS) + f" [{label}]", flush=True)
    ok = True
    for kind in KINDS:
        got = [np.load(out / f"{kind}.npy") for _, out, _ in runs]
        equal = all(np.array_equal(got[0], g, equal_nan=True)
                    for g in got[1:])
        ok &= equal
        med = {n: statistics.median(r[kind]["cuda"] for m, _, r in runs
                                    if m == n) for n in trees}
        torch_med = {n: statistics.median(r[kind]["torch"] for m, _, r in runs
                                          if m == n) for n in trees}
        print(f"[parent] {kind} tier build: the four impl=cuda builds "
              f"bitwise equal {equal}; median s impl=cuda earlier "
              f"{med['earlier']:.3f}, this {med['this']:.3f} (this / earlier "
              f"{med['this'] / med['earlier']:.3f}); impl=torch earlier "
              f"{torch_med['earlier']:.3f}, this {torch_med['this']:.3f} "
              f"{'ok' if equal else 'FAIL'} [{label}]", flush=True)
    return ok


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"sg_parent_probe: {what}: not on the bucket kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--extract", action="store_true")
    ap.add_argument("--rev", default="HEAD~1")
    ap.add_argument("--no-builds", action="store_true")
    ap.add_argument("--turn", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.extract:
        extract(args.rev)
        return 0
    if args.turn:
        turn(args.turn, args.out)
        return 0
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("sg_parent_probe: no CUDA device", file=sys.stderr)
        return 1
    if not (OUT / "REV").exists():
        print(f"sg_parent_probe: no earlier source in {OUT}; run with "
              f"--extract in a git checkout first", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    label = smoke.card()
    ok = kernel_rows(label)
    if not args.no_builds:
        ok &= builds(label)
    print(f"[parent] all held: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
