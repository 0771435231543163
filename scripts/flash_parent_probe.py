#!/usr/bin/env python3
"""Card probe: the wgmma flash kernel of this tree against an earlier
commit's, at phi3's, pixtral's, Jamba's, MLA's and whisper's shapes.

    python3 scripts/flash_parent_probe.py --extract [--rev HEAD~1]  # in git
    python3 scripts/flash_parent_probe.py                           # on a GPU

``--extract`` writes the earlier commit's ``csrc/flash_attention.cu`` and
the ``csrc`` headers it includes (``git show REV:...``) to
``build/flash_parent/`` (which ``.gitignore`` covers) with the revision's
hash beside them, and exits; the machine with the card need not hold the
repository's history. Without it, the probe builds that copy with this
tree's nvcc flags into the same directory, builds this tree's kernel
(``kernels/build.py``), and at phi3's (B=1, H=40, 10 KV heads, S=8192,
D=128, causal), pixtral's (B=1, H=32, 8 KV heads, S=8192, D=128, causal),
Jamba's (B=1, H=64, 8 KV heads, S=8192, D=128, causal), MLA's (B=1, H=16,
S=8192, q/k 192, v 128, causal) and whisper's encoder (B=16, H=6, S=1500,
D=64, non-causal) and decoder (B=16, H=6, S=448, D=64, causal) shapes
launches both on the same bf16 inputs (seeded on the card). Where
``SAME_CODE`` says this tree runs the earlier kernel's code ((192, 128))
the outputs must be bitwise equal (``torch.equal``); at D=64 and D=128,
which run kernels of their own, each is held by ``flash_bf16_check``
instead. It times the earlier kernel, this tree's
and SDPA in turns (``chip_smoke.turns``: 5 rounds, the order reversed
every other round, through the host and in a CUDA graph; the kernels by a
direct ``ctypes`` call each, through the same host path) and this tree's
kernel through the ``flash_attention`` wrapper, and prints one line a
shape. The earlier kernel's C entry must take v's width (Dv) as this
tree's does. Exits 1 unless every check holds.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "flash_parent"
CSRC = "src/repro_torch/csrc"
SHAPES = (  # what, B, H, Kh, S, D, Dv, causal
    ("phi3", 1, 40, 10, 8192, 128, 128, True),
    ("pixtral", 1, 32, 8, 8192, 128, 128, True),
    ("Jamba", 1, 64, 8, 8192, 128, 128, True),
    ("MLA", 1, 16, 16, 8192, 192, 128, True),
    ("whisper encoder", 16, 6, 6, 1500, 64, 64, False),
    ("whisper decoder", 16, 6, 6, 448, 64, 64, True),
)
SAME_CODE = {192}           # q/k widths whose kernel code this tree keeps


def extract(rev: str) -> None:
    """The revision's kernel source and the headers it includes, to OUT."""
    def show(name):
        return subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                              cwd=ROOT, check=True, capture_output=True,
                              text=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    todo, seen = ["flash_attention.cu"], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        text = show(name)
        (OUT / name).write_text(text)
        todo += [h for h in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text,
                                       re.M)]
    sha = subprocess.run(["git", "rev-parse", rev], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    (OUT / "REV").write_text(sha + "\n")
    print(f"extracted {sorted(seen)} of {sha} to {OUT}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--extract", action="store_true")
    ap.add_argument("--rev", default="HEAD~1")
    args = ap.parse_args()
    if args.extract:
        extract(args.rev)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_parent_probe: no CUDA device", file=sys.stderr)
        return 1
    if not (OUT / "flash_attention.cu").exists():
        print(f"flash_parent_probe: no earlier source in {OUT}; run with "
              f"--extract in a git checkout first", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from flash_fault_check import launch
    import torch.nn.functional as F
    from repro_torch.kernels import build, flash_attention as fa
    label = smoke.card()
    rev = (OUT / "REV").read_text().strip()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; earlier kernel from {rev}", flush=True)
    so = OUT / "flash_attention_parent.so"
    p = subprocess.run(build.nvcc_command(OUT / "flash_attention.cu", so),
                       capture_output=True, text=True)
    if p.returncode:
        print(p.stderr, file=sys.stderr)
        return 1
    old = ctypes.CDLL(str(so))
    new = fa._lib()

    ok = True
    for what, B, H, KH, S, D, DV, causal in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(S + D)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((B, H, S, D), (B, KH, S, D), (B, KH, S, DV)))
        check(fa.flash_variant(q.dtype, D, DV) == "wgmma", what)
        before = fa.variant_launches["wgmma"]
        got = fa.flash_attention(q, k, v, causal=causal)
        again = fa.flash_attention(q, k, v, causal=causal)
        was = launch(old, q, k, v, causal)
        torch.cuda.synchronize()
        check(fa.variant_launches["wgmma"] == before + 2, what)
        if D in SAME_CODE:
            held = bool(torch.equal(got, was))
            verdict = f"bitwise equal {held}"
        else:
            kv = [t.repeat_interleave(H // KH, dim=1) for t in (k, v)]
            want = fa.flash_attention_ref(q.float(), *(t.float() for t in kv),
                                          causal=causal)
            tol = fa.flash_bf16_tol(q, *kv, causal=causal)
            r = fa.flash_bf16_check(got, again, want, tol)
            r_old = fa.flash_bf16_check(was, launch(old, q, k, v, causal),
                                        want, tol)
            held = r["ok"] and r_old["ok"]
            verdict = (f"flash_bf16_check this: worst {r['worst']:.3f}, "
                       f"mean signed error {r['bias_ulp']:+.4f} ulp, "
                       f"repeatable {r['repeatable']}; earlier: worst "
                       f"{r_old['worst']:.3f}, {r_old['bias_ulp']:+.4f} "
                       f"ulp; equal to the earlier "
                       f"{float((got == was).float().mean()):.4f}")
        ok &= held
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=KH < H)
        t = smoke.turns({"earlier": lambda: launch(old, q, k, v, causal),
                         "this": lambda: launch(new, q, k, v, causal),
                         "sdpa": sdpa}, iters=50 if S > 4096 else 200)
        med = {n: {w: statistics.median(x) for w, x in r.items()}
               for n, r in t.items()}
        wrapped = smoke.cuda_ms(lambda: fa.flash_attention(q, k, v,
                                                           causal=causal))
        print(f"[parent] {what} B={B} H={H} Kh={KH} S={S} D={D} Dv={DV} "
              f"{'causal' if causal else 'non-causal'}: {verdict}; medians "
              f"[min-max] of 5 rounds in turns, ms through the host / in a "
              f"CUDA graph: earlier {smoke.spread(t['earlier']['host'])} / "
              f"{smoke.spread(t['earlier']['graph'])}, this "
              f"{smoke.spread(t['this']['host'])} / "
              f"{smoke.spread(t['this']['graph'])}, SDPA "
              f"{smoke.spread(t['sdpa']['host'])} / "
              f"{smoke.spread(t['sdpa']['graph'])}; this / earlier "
              f"{med['this']['host'] / med['earlier']['host']:.3f} / "
              f"{med['this']['graph'] / med['earlier']['graph']:.3f}, this "
              f"/ SDPA {med['this']['host'] / med['sdpa']['host']:.3f} / "
              f"{med['this']['graph'] / med['sdpa']['graph']:.3f}; this "
              f"through flash_attention {wrapped:.4f} "
              f"{'ok' if held else 'FAIL'} [{label}]", flush=True)
    print(f"[parent] all held: {ok}", flush=True)
    return 0 if ok else 1


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"flash_parent_probe: {what}: not on the wgmma "
                         f"kernel")


if __name__ == "__main__":
    sys.exit(main())
