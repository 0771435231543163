#!/usr/bin/env python3
"""Card probe: the fused GNN layer's tensor-core kernels of this tree
against an earlier commit's, at the serving rows.

    python3 scripts/fused_parent_probe.py --extract [--rev HEAD~1]  # in git
    python3 scripts/fused_parent_probe.py                           # on a GPU

``--extract`` writes the earlier commit's ``csrc/fused_gnn.cu``, the
``csrc`` headers it includes and its wrapper ``kernels/fused_gnn.py``
(``git show REV:...``) to ``build/fused_parent/`` (which ``.gitignore``
covers) with the revision's hash beside them, and exits; the machine with
the card need not hold the repository's history. Without it, the probe builds that copy with this
tree's nvcc flags into the same directory, builds this tree's kernel
(``kernels/build.py``), and on ``chip_smoke.py``'s serving batch of the
Flickr-sized graph (C=64, N=256, seed-0 weights) launches both at the five
fp32 rows of ``chip_smoke.fused_rows`` (Fin 512 and 256, w_neigh and
+w_self; the self-only Transform) on the ``tf32x3`` kernel and at the same
rows in bf16 on the ``wgmma_bf16`` kernel. This tree's ``tf32x3`` kernel
takes the weights split (``fused_gnn.weight_split``, made before the
timing, as the serving path keeps them); the earlier one takes them as
they are. Where ``--same-bits`` (the default) says the two kernels sum in
the same order, the outputs must be bitwise equal (``torch.equal``); each
output is also held to the plain version (2e-5 for fp32, ``bf16_reading``
and ``bf16_bias_ulp`` for bf16). It times the earlier kernel, this tree's
and the ``baddbmm`` chain (``chip_smoke.py``'s library call) in turns
(``chip_smoke.turns``: 5 rounds, the order reversed every other round,
through the host and in a CUDA graph; the kernels by a direct ``ctypes``
call each, through the same host path), and this tree's kernel through the
``fused_gnn_layer`` wrapper, with each wrapper's host time a call
(``chip_smoke.host_us``: the earlier wrapper on the earlier library, this
one on this tree's), and prints one line a row. Then (``--engine``, the
default) it serves GCN, GraphSAGE and GAT dense (``chip_smoke.py``'s
[engine] models: L=5, N=256, C=64, seed-0 weights, Zipf targets) through
``DecoupledEngine`` with impl="cuda", once with the earlier wrapper and
library in ``kernels.ops`` and once with this tree's, in turns (earlier,
this, this, earlier; a warm-up batch each, then 8 batches, then the same
8 under ``torch.profiler``), and prints each turn's p50 device step on
the host's clock, the card's busy time a batch and the ``tf32x3``
kernel's part of it, and whether the embeddings of the two trees are
bitwise equal. Exits 1 unless every check holds.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "fused_parent"
CSRC = "src/repro_torch/csrc"


def extract(rev: str) -> None:
    """The revision's kernel source and the headers it includes, to OUT."""
    def show(name):
        return subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                              cwd=ROOT, check=True, capture_output=True,
                              text=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    todo, seen = ["fused_gnn.cu"], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        text = show(name)
        (OUT / name).write_text(text)
        todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M)
    (OUT / "fused_gnn_wrapper.py").write_text(subprocess.run(
        ["git", "show", f"{rev}:src/repro_torch/kernels/fused_gnn.py"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout)
    sha = subprocess.run(["git", "rev-parse", rev], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    (OUT / "REV").write_text(sha + "\n")
    print(f"extracted {sorted(seen)} of {sha} to {OUT}")


def typed(lib):
    """``lib`` with the tensor-core entries' argument types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fused_gnn_layer_tf32x3, lib.fused_gnn_layer_wgmma_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return lib


def earlier_wrapper(lib):
    """The earlier commit's ``kernels/fused_gnn.py`` as a module of its own
    (its own launch counters), loading ``lib`` for its kernels."""
    from repro_torch.kernels import build
    spec = importlib.util.spec_from_file_location(
        "fused_gnn_earlier", OUT / "fused_gnn_wrapper.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Build:
        refuse_grad = staticmethod(build.refuse_grad)

        @staticmethod
        def load(name):
            return lib
    mod.build = Build
    return mod


def engine_turns(old_fn, label, batches: int = 8) -> bool:
    """The dense engines' device step with the earlier wrapper and with this
    tree's, in turns: the step on the host's clock (p50), and from
    ``torch.profiler`` the card's busy time a batch and the fused kernel's
    part of it. True where the two trees' embeddings are bitwise equal."""
    import numpy as np
    import torch
    import chip_smoke as smoke
    from repro_torch.core.config import ServingConfig
    from repro_torch.core.engine import DecoupledEngine
    from repro_torch.gnn.model import GNNConfig, init_gnn
    from repro_torch.kernels import fused_gnn as fg, ops
    graph, targets, _ = smoke.serving_batch()
    targets = targets[:batches * smoke.C]
    cuda = torch.autograd.DeviceType.CUDA
    ok = True
    for kind in ("gcn", "sage", "gat"):
        cfg = GNNConfig(kind=kind, n_layers=smoke.LAYERS,
                        receptive_field=smoke.N, f_in=smoke.F_IN,
                        f_hidden=smoke.F_HID, n_heads=smoke.HEADS)
        params = init_gnn(cfg, seed=0, device="cuda")
        conf = ServingConfig(device="cuda", batch_size=smoke.C, mode="dense",
                             impl="cuda")
        got = {"earlier": [], "this": []}
        embs = {}
        with DecoupledEngine(graph, cfg, params=params, config=conf) as eng:
            for turn in ("earlier", "this", "this", "earlier"):
                ops.fused_gnn_layer = old_fn if turn == "earlier" \
                    else fg.fused_gnn_layer
                try:
                    eng.infer(targets[:smoke.C])           # warm-up batch
                    torch.cuda.synchronize()
                    res = eng.infer(targets)
                    torch.cuda.synchronize()
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        eng.infer(targets)
                        torch.cuda.synchronize()
                finally:
                    ops.fused_gnn_layer = fg.fused_gnn_layer
                ev = [e for e in prof.key_averages()
                      if e.device_type == cuda]
                busy = sum(e.self_device_time_total for e in ev)
                fused = sum(e.self_device_time_total for e in ev
                            if "fused_tf32x3" in e.key)
                got[turn].append((
                    float(np.median(res.stats.device_times)) * 1e3,
                    busy / batches / 1e3, fused / batches / 1e3))
                embs[turn] = res.embeddings
        same = bool(np.array_equal(embs["earlier"], embs["this"]))
        ok &= same
        e, t = got["earlier"], got["this"]
        order = (e[0], t[0], t[1], e[1])
        diff = [(t[0][i] + t[1][i] - e[0][i] - e[1][i]) / 2
                for i in range(3)]
        print(f"[parent] engine {kind}/dense, {batches} batches x C="
              f"{smoke.C}, in turns (earlier, this, this, earlier), ms a "
              f"batch: device step p50 (host clock) "
              f"{', '.join(f'{x[0]:.4f}' for x in order)}; card busy "
              f"(profiler) {', '.join(f'{x[1]:.4f}' for x in order)}; "
              f"tf32x3 kernel {', '.join(f'{x[2]:.4f}' for x in order)}; "
              f"this - earlier: step {diff[0]:+.4f}, busy {diff[1]:+.4f}, "
              f"kernel {diff[2]:+.4f}; embeddings bitwise equal {same} "
              f"[{label}]", flush=True)
    return ok


def launch(lib, args, act="relu", split=False):
    """``lib``'s tensor-core kernel for ``args`` (adj, h, w_neigh, w_self,
    b, mask) by a direct ``ctypes`` call on the current stream (the
    wrapper's checks left out; ``split``: the weights go as this tree's
    ``tf32x3`` kernel reads them); returns the new output."""
    import torch
    from repro_torch.kernels import fused_gnn as fg
    adj, h, wn, ws, b, m = args
    bf16 = h.dtype == torch.bfloat16
    C, N, Fin = h.shape
    Fout = (wn if wn is not None else ws).shape[-1]
    if split and not bf16:
        wn, ws = (None if w is None else fg.weight_split(w)
                  for w in (wn, ws))
    out = torch.empty((C, N, Fout), dtype=h.dtype, device=h.device)
    fn = lib.fused_gnn_layer_wgmma_bf16 if bf16 \
        else lib.fused_gnn_layer_tf32x3
    ptr = [None if t is None else t.data_ptr()
           for t in (adj if wn is not None else None, h, wn, ws, b, m, out)]
    err = fn(*ptr, C, N, Fin, Fout, fg.ACT_CODES[act],
             torch._C._cuda_getCurrentRawStream(h.device.index))
    if err:
        raise RuntimeError(f"fused_parent_probe: launch failed ({err})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--extract", action="store_true")
    ap.add_argument("--rev", default="HEAD~1")
    ap.add_argument("--no-same-bits", dest="same_bits", action="store_false",
                    help="the two kernels sum in other orders: hold each to "
                         "the plain version only")
    ap.add_argument("--no-engine", dest="engine", action="store_false",
                    help="leave out the engines' device steps")
    args = ap.parse_args()
    if args.extract:
        extract(args.rev)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("fused_parent_probe: no CUDA device", file=sys.stderr)
        return 1
    if not (OUT / "fused_gnn.cu").exists():
        print(f"fused_parent_probe: no earlier source in {OUT}; run with "
              f"--extract in a git checkout first", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.kernels import build, fused_gnn as fg
    from repro_torch.kernels.ref import bf16_bias_ulp, bf16_reading
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = smoke.card()
    rev = (OUT / "REV").read_text().strip()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; earlier kernel from {rev}", flush=True)
    so = OUT / "fused_gnn_parent.so"
    p = subprocess.run(build.nvcc_command(OUT / "fused_gnn.cu", so),
                       capture_output=True, text=True)
    if p.returncode:
        print(p.stderr, file=sys.stderr)
        return 1
    old = typed(ctypes.CDLL(str(so)))
    new = typed(fg._lib())
    old_wrapper = earlier_wrapper(old)

    _, _, sb = smoke.serving_batch()
    x = smoke.gnn_inputs(sb, torch.device("cuda"))
    rows = [(tag, a, kw) for tag, a, kw in smoke.fused_rows(x)]
    rows += [(tag, a, kw) for tag, a, kw, v in smoke.fused_bf16_rows(x)
             if v == "wgmma_bf16" and tag.startswith(f"C={smoke.C} ")]
    ok = True
    for tag, a, kw in rows:
        act = kw.get("act", "relu")
        bf16 = a[1].dtype == torch.bfloat16
        variant = "wgmma_bf16" if bf16 else "tf32x3"
        before = fg.variant_launches[variant]
        got = fg.fused_gnn_layer(*a, **kw)
        again = launch(new, a, act, split=True)
        was = launch(old, a, act)
        torch.cuda.synchronize()
        on = fg.variant_launches[variant] == before + 1
        same = bool(torch.equal(got, was))
        if bf16:
            want = fg.fused_gnn_layer_ref(*smoke.widened(a), **kw)
            held, worst, err = bf16_reading(got, want)
            held_old = bf16_reading(was, want)[0]
            bias = bf16_bias_ulp(got, want)
            text = (f"worst {worst} bf16 ulp outside 2e-5, mean signed error "
                    f"{bias:+.4f} ulp")
            held = held and held_old and abs(bias) <= smoke.BF16_BIAS_ULP
        else:
            want = fg.fused_gnn_layer_ref(*a, **kw)
            held, text, _ = smoke.reading(got, want)
            held = held and smoke.reading(was, want)[0]
        held = held and on and torch.equal(got, again) and (
            same or not args.same_bits)
        ok &= held
        t = smoke.turns({"earlier": lambda: launch(old, a, act),
                         "this": lambda: launch(new, a, act, split=True),
                         "baddbmm": smoke.fused_library(a, kw)}, iters=200)
        med = {n: {w: statistics.median(v) for w, v in r.items()}
               for n, r in t.items()}
        made = fg.splits_made
        wrapped = smoke.cuda_ms(lambda: fg.fused_gnn_layer(*a, **kw),
                                iters=200)
        us = smoke.host_us(lambda: fg.fused_gnn_layer(*a, **kw))
        us_old = smoke.host_us(lambda: old_wrapper.fused_gnn_layer(*a, **kw))
        made = fg.splits_made - made
        held = held and made == 0 and torch.equal(
            old_wrapper.fused_gnn_layer(*a, **kw), got)
        bnd, by = (smoke.fused_bf16_bound(a) if bf16
                   else smoke.fused_bound(a))
        print(f"[parent] {tag} ({variant}): {text}; bitwise equal to the "
              f"earlier {same}; medians [min-max] of 5 rounds in turns, ms "
              f"through the host / in a CUDA graph: earlier "
              f"{smoke.spread(t['earlier']['host'])} / "
              f"{smoke.spread(t['earlier']['graph'])}, this "
              f"{smoke.spread(t['this']['host'])} / "
              f"{smoke.spread(t['this']['graph'])}, baddbmm chain "
              f"{smoke.spread(t['baddbmm']['host'])} / "
              f"{smoke.spread(t['baddbmm']['graph'])}; this / earlier "
              f"{med['this']['host'] / med['earlier']['host']:.3f} / "
              f"{med['this']['graph'] / med['earlier']['graph']:.3f}, this "
              f"/ baddbmm {med['this']['host'] / med['baddbmm']['host']:.3f}"
              f" / {med['this']['graph'] / med['baddbmm']['graph']:.3f}; "
              f"bound {bnd:.4f} ms ({by}); this through fused_gnn_layer "
              f"{wrapped:.4f} ms, the wrappers' host time a call: this "
              f"{us:.2f} us, earlier {us_old:.2f} us; weight splits made "
              f"while timed {made} "
              f"{'ok' if held else 'FAIL'} [{label}]",
              flush=True)
    if args.engine:
        ok &= engine_turns(old_wrapper.fused_gnn_layer, label)
    print(f"[parent] all held: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
