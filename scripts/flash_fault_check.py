#!/usr/bin/env python3
"""Control readings for the checks that hold ``flash_attention``'s wgmma
kernels on a GPU.

    python3 scripts/flash_fault_check.py [--widths 64,64 128,128 192,128]

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one fault
planted in a wgmma kernel of each (in a temporary directory; the
repository is not written), and runs the unchanged kernel and each faulty
one through the checks of ``chip_smoke.py`` that reach it, at each
(q/k width, v width) of ``--widths``:

- the kernel against its plain version: ``flash_bf16_check``, that is
  (a) every element within ``flash_bf16_tol``, (b) the mean signed error
  within 0.1 bf16 ulp, (c) two launches bitwise equal. At (64, 64) the
  shapes are whisper's encoder (B=16, H=6, S=1500, non-causal) and decoder
  (B=16, H=6, S=448, causal), at (128, 128) phi3's prefill (B=1, H=40, 10
  KV heads, S=8192, bf16, causal), at (192, 128) MLA prefill's (B=1, H=16,
  S=8192, bf16, causal);
- at (128, 128) only, phi3-medium-14b at full width, 8 layers, one
  8192-token prompt: ``prefill(impl="cuda")`` through the kernel against
  ``prefill(impl="torch")``, at ``LM_TOL``.

Each fault names the widths whose code it reaches, and is planted there:
the D=128 template's (128, 128) and (192, 128) (``TEMPLATE``), what only
the (192, 128) instance runs (the third 64-column box of Q and K, the V
stage narrower than K's, the output's row stride DV), what only the D=64
kernel runs (its overlapped Q.K^T, its rescale after P.V, its last P.V,
its per-warpgroup tile count), and the bf16 store all of them share. No
fault leaves a barrier waiting for bytes that never come, and none writes
outside the output.

Prints each fault's prediction (written before its first run), then one
line per kernel, width, shape and check with the reading and the verdict.
Exits 1 unless the unchanged kernel passes every check and every planted
fault fails (a), (b) or (c) at some shape of each width it is planted at,
except a race (``RACES``): whether a race shows in the output depends on
timing no check controls, so its verdict, caught or not, is printed and
does not decide the exit code.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _parts, flash_attention, flash_bf16_check, flash_bf16_tol)
from repro_torch.models import transformer  # noqa: E402

TEMPLATE = ((128, 128), (192, 128))
ALL = ((64, 64),) + TEMPLATE

# name -> (text of the kernel source, what replaces it, prediction, the
# (q/k, v) widths whose code it reaches)
FAULTS = {
    "skip the diagonal tile": (
        "const int n_tiles = (k_end + BK - 1) / BK;",
        "const int n_tiles = causal ? q0 / BK : (k_end + BK - 1) / BK;",
        "fails (a) and LM_TOL: the first query block has no keys at all",
        TEMPLATE),
    "p scaled by 0.9 in P.V": (
        "p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);",
        "p[i] = pack_bf16(0.9f * sc[2 * i], 0.9f * sc[2 * i + 1]);",
        "fails (a) (early rows, where |ref| is near A) and (b) (about -18 "
        "ulp); likely LM_TOL", TEMPLATE),
    "no rescale of the accumulator by alpha": (
        "      o[4 * i] *= alpha0;\n      o[4 * i + 1] *= alpha0;\n"
        "      o[4 * i + 2] *= alpha1;\n      o[4 * i + 3] *= alpha1;\n",
        "",
        "fails (a) and LM_TOL", TEMPLATE),
    "truncating bf16 store": (
        "= __floats2bfloat162_rn(a, b);",
        "= __halves2bfloat162(__float2bfloat16_rz(a), "
        "__float2bfloat16_rz(b));",
        "fails (b) only (about -0.5 ulp); passes (a), (c) and LM_TOL", ALL),
    "stage released before its P.V wgmma is waited on": (
        "    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(o);\n"
        "    if (tid == 0) mbar_arrive(empty(s));",
        "    wgmma_commit();\n    if (tid == 0) mbar_arrive(empty(s));\n"
        "    wgmma_wait_all();\n    fence_regs(o);",
        "a race: the producer's next TMA may overwrite V while the wgmma "
        "reads it; caught by (c) only if it lands in some tile of the two "
        "launches, which is not certain", TEMPLATE),
    # what only the (192, 128) instance runs: each a no-op where DK == DV
    "Q.K^T stops after two of its three 64-column boxes": (
        "for (int kk = 0; kk < DK / 16; ++kk) {",
        "for (int kk = 0; kk < (DK > 128 ? 128 : DK) / 16; ++kk) {",
        "fails (a): the scores lose a third of each dot product",
        ((192, 128),)),
    "the second V box is never loaded": (
        "        mbar_expect_tx(v_full(s), S::V);\n"
        "        for (int b = 0; b < V_BOXES; ++b)",
        "        mbar_expect_tx(v_full(s), DK != DV ? S::V - BOX_KV : S::V);\n"
        "        for (int b = 0; b < (DK != DV ? V_BOXES - 1 : V_BOXES); ++b)",
        "fails (a): output columns 64-127 are P times whatever that shared "
        "memory held; likely (c) too", ((192, 128),)),
    "output at row stride DK": (
        "    if (r0 < Sq)\n"
        "      store_bf16x2(&ob[(long long)r0 * DV + c], o[4 * i] / den0,\n"
        "                   o[4 * i + 1] / den0);\n"
        "    if (r1 < Sq)\n"
        "      store_bf16x2(&ob[(long long)r1 * DV + c], o[4 * i + 2] / den1,",
        "    if (r0 < Sq && (long long)r0 * DK + c < (long long)Sq * DV)\n"
        "      store_bf16x2(&ob[(long long)r0 * DK + c], o[4 * i] / den0,\n"
        "                   o[4 * i + 1] / den0);\n"
        "    if (r1 < Sq && (long long)r1 * DK + c < (long long)Sq * DV)\n"
        "      store_bf16x2(&ob[(long long)r1 * DK + c], o[4 * i + 2] / den1,",
        "fails (a): rows land at the wrong places (kept inside the head's "
        "output), a third of the output is never written", ((192, 128),)),
    # what only the D=64 kernel runs
    "D=64: the overlapped Q.K^T reads the previous tile's stage": (
        "        mbar_wait(k_full(s), ((g + 1) / STAGES) & 1);\n"
        "        qk(sc, sq, sK + s * KV_BYTES);",
        "        mbar_wait(k_full(s), ((g + 1) / STAGES) & 1);\n"
        "        qk(sc, sq, sK + sp * KV_BYTES);",
        "fails (a) at both shapes: every tile after the first is scored "
        "against the keys before it", ((64, 64),)),
    "D=64: no rescale of O by alpha after P.V": (
        "          o[4 * e] *= alpha[0];\n          o[4 * e + 1] *= alpha[0];\n"
        "          o[4 * e + 2] *= alpha[1];\n"
        "          o[4 * e + 3] *= alpha[1];\n",
        "",
        "fails (a) at both shapes (every row but the decoder's first 128 "
        "sees more than one tile)", ((64, 64),)),
    "D=64: the last tile's P.V dropped": (
        "      s = g % STAGES;\n      mbar_wait(v_full(s), (g / STAGES) & 1);\n"
        "      pv(o, p, sV + s * KV_BYTES);\n",
        "      s = g % STAGES;\n      mbar_wait(v_full(s), (g / STAGES) & 1);\n",
        "fails (a) at both shapes: each row loses its last tile's values",
        ((64, 64),)),
    "D=64: a warpgroup's diagonal tile skipped (causal)": (
        "(min(Sk, r_last + 1) + BK - 1) / BK)",
        "(min(Sk, r_last + 1) + BK - 1) / BK - 1)",
        "fails (a) at the decoder's causal shape only (rows lose their "
        "diagonal keys, the first 128 rows are never written, so likely (c) "
        "too); the encoder is not causal", ((64, 64),)),
    "D=64: stage released before its P.V is waited on": (
        "        wgmma_wait<0>();                          // P_{j-1} V_{j-1} "
        "done\n        fence_regs(o);\n        fence_regs(p);\n"
        "        if (lead) mbar_arrive(empty(sp));         // release tile j - 1\n",
        "        if (lead) mbar_arrive(empty(sp));         // release tile j - 1\n"
        "        wgmma_wait<0>();                          // P_{j-1} V_{j-1} "
        "done\n        fence_regs(o);\n        fence_regs(p);\n",
        "a race: the producer may load a tile four ahead into V while P.V "
        "reads it; caught by (c) only if it lands, which is not certain",
        ((64, 64),)),
}

RACES = {"stage released before its P.V wgmma is waited on",
         "D=64: stage released before its P.V is waited on"}


def build_faults(tmp: Path):
    """One nvcc per faulty copy, all started together; {name: .so}."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for i, (name, (old, new, *_)) in enumerate(FAULTS.items()):
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name!r}: its text is not in the "
                               f"kernel source once")
        cu, so = tmp / f"fault{i}.cu", tmp / f"fault{i}.so"
        cu.write_text(src.replace(old, new))
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


def use(lib) -> None:
    """Makes ``flash_attention`` launch the kernels of ``lib``."""
    build._libs["flash_attention"] = lib


def inputs(widths):
    """[(shape label, q, k, v, causal)] on the card: the shapes the checks
    of ``widths`` use."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(B, heads, S, d):
        return torch.randn((B, heads, S, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
    if widths == (64, 64):
        return [(f"B=16 H=6 S={S} {'causal' if causal else 'non-causal'}",
                 rnd(16, 6, S, 64), rnd(16, 6, S, 64), rnd(16, 6, S, 64),
                 causal) for S, causal in ((1500, False), (448, True))]
    B, H, Kh = (1, 40, 10) if widths == (128, 128) else (1, 16, 16)
    return [(f"B={B} H={H} Kh={Kh} S={smoke.LM_SEQ} causal",
             rnd(B, H, smoke.LM_SEQ, widths[0]),
             rnd(B, Kh, smoke.LM_SEQ, widths[0]),
             rnd(B, Kh, smoke.LM_SEQ, widths[1]), True)]


def kernel_checks(kernels, widths, label):
    """{kernel name: passes at every shape} of ``flash_bf16_check`` at
    ``widths``."""
    kernel_ok = dict.fromkeys(kernels, True)
    for shape, q, k, v, causal in inputs(widths):
        G = q.shape[1] // k.shape[1]
        kg, vg = (t.repeat_interleave(G, dim=1) for t in (k, v))
        p, den, vf = _parts(q, kg, vg, causal)
        want = torch.einsum("bhqk,bhkd->bhqd", p, vf).div_(den)
        del p, den, vf
        tol = flash_bf16_tol(q, kg, vg, causal=causal)
        del kg, vg
        for name, lib in kernels.items():
            use(lib)
            out = flash_attention(q, k, v, causal=causal)
            again = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            r = flash_bf16_check(out, again, want, tol)
            kernel_ok[name] &= r["ok"]
            print(f"[kernel {widths[0]},{widths[1]}] {name} at {shape}: "
                  f"max_abs_err {r['max_abs_err']:.3e}, (a) worst "
                  f"{r['worst']:.3f} of the tolerance, (b) mean signed "
                  f"error {r['bias_ulp']:+.4f} ulp, (c) repeatable "
                  f"{r['repeatable']} -> "
                  f"{'passes' if r['ok'] else 'fails'} [{label}]",
                  flush=True)
            del out, again
    return kernel_ok


def lm_checks(kernels, label):
    """{kernel name: passes} of phi3's 8-layer prefill at ``LM_TOL``."""
    cfg = dataclasses.replace(get_config(smoke.LM_ARCH),
                              n_layers=smoke.LM_LAYERS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, smoke.LM_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    plain = transformer.prefill(cfg, params, batch, impl="torch")
    lm_ok = {}
    for name, lib in kernels.items():
        use(lib)
        logits = transformer.prefill(cfg, params, batch, impl="cuda")
        rel, top1 = smoke._agreement(logits, plain)
        lm_ok[name] = ok = (rel <= smoke.LM_TOL["rel"]
                            and top1 >= smoke.LM_TOL["top1"])
        print(f"[lm] {name}: max abs err / max |logit| {rel:.3e}, "
              f"top-1 agreement {top1:.4f} (tolerance {smoke.LM_TOL}) "
              f"-> {'passes' if ok else 'fails'} [{label}]", flush=True)
        del logits
    return lm_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", nargs="+",
                    default=["64,64", "128,128", "192,128"],
                    choices=["64,64", "128,128", "192,128"],
                    help="(q/k, v) widths of the wgmma instances to check")
    args = ap.parse_args(argv)
    widths = [tuple(int(x) for x in w.split(",")) for w in args.widths]
    if not torch.cuda.is_available():
        print("flash_fault_check: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (_, _, prediction, where) in FAULTS.items():
        print(f"[predicted] {name} (at {', '.join(map(str, where))}): "
              f"{prediction}", flush=True)
    good = build.load("flash_attention")
    checked = {}                     # (kernel name, check) -> passes
    with tempfile.TemporaryDirectory() as tmp:
        faulty = build_faults(Path(tmp))
        for w in widths:
            planted = {n: lib for n, lib in faulty.items()
                       if w in FAULTS[n][3]}
            kernels = {"unchanged kernel": good, **planted}
            for name, ok in kernel_checks(kernels, w, label).items():
                checked[name, f"kernel {w[0]},{w[1]}"] = ok
            if w == (128, 128):
                for name, ok in lm_checks(kernels, label).items():
                    checked[name, "lm"] = ok
    use(good)
    unchanged = all(ok for (n, _), ok in checked.items()
                    if n == "unchanged kernel")
    gating = [key for key in checked if key[0] != "unchanged kernel"
              and key[0] not in RACES]
    kernel_keys = [key for key in gating if key[1] != "lm"]
    lm_keys = [key for key in gating if key[1] == "lm"]
    ok = unchanged and not any(checked[key] for key in kernel_keys)
    print(f"[summary] unchanged kernel passes every check: {unchanged}; "
          f"planted faults caught by the kernel check: "
          f"{sum(not checked[key] for key in kernel_keys)} of "
          f"{len(kernel_keys)}, by LM_TOL: "
          f"{sum(not checked[key] for key in lm_keys)} of {len(lm_keys)}",
          flush=True)
    for (n, check), passed in checked.items():
        if n in RACES and check != "lm":
            print(f"[summary] race {n!r} at {check}: "
                  f"{'NOT CAUGHT' if passed else 'caught'} by the kernel "
                  f"check (reported; does not decide the exit code)",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
