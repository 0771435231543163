#!/usr/bin/env python3
"""Control readings for the checks that hold ``flash_attention``'s wgmma
kernel on a GPU.

    python3 scripts/flash_fault_check.py [--widths 128,128 192,128]

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one fault
planted in the wgmma kernel of each (in a temporary directory; the
repository is not written), and runs the unchanged kernel and each faulty
one through the checks of ``chip_smoke.py`` that reach it, at each
(q/k width, v width) of ``--widths``:

- the kernel against its plain version: ``flash_bf16_check``, that is
  (a) every element within ``flash_bf16_tol``, (b) the mean signed error
  within 0.1 bf16 ulp, (c) two launches bitwise equal. At (128, 128) the
  shape is phi3's prefill (B=1, H=40, 10 KV heads, S=8192, bf16, causal),
  at (192, 128) MLA prefill's (B=1, H=16, S=8192, bf16, causal);
- at (128, 128) only, phi3-medium-14b at full width, 8 layers, one
  8192-token prompt: ``prefill(impl="cuda")`` through the kernel against
  ``prefill(impl="torch")``, at ``LM_TOL``.

``FAULTS`` sit in code every instance runs and are planted at each width;
``MLA_FAULTS`` sit in what only the (192, 128) instance runs (the third
64-column box of Q and K, the V stage narrower than K's, the output's row
stride DV), leave the other instances as they are, and are planted at
(192, 128) only. No fault leaves a barrier waiting for bytes that never
come, and none writes outside the output.

Prints each fault's prediction (written before its first run), then one
line per kernel, width and check with the reading and the verdict. Exits 1
unless the unchanged kernel passes every check and every planted fault
fails (a), (b) or (c) at each width it is planted at, except a race
(``RACES``): whether a race shows in the output depends on timing no check
controls, so its verdict, caught or not, is printed and does not decide
the exit code.
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

# name -> (text of the kernel source, what replaces it, prediction)
FAULTS = {
    "skip the diagonal tile": (
        "const int n_tiles = (k_end + BK - 1) / BK;",
        "const int n_tiles = causal ? q0 / BK : (k_end + BK - 1) / BK;",
        "fails (a) and LM_TOL: the first query block has no keys at all"),
    "p scaled by 0.9 in P.V": (
        "p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);",
        "p[i] = pack_bf16(0.9f * sc[2 * i], 0.9f * sc[2 * i + 1]);",
        "fails (a) (early rows, where |ref| is near A) and (b) (about -18 "
        "ulp); likely LM_TOL"),
    "no rescale of the accumulator by alpha": (
        "      o[4 * i] *= alpha0;\n      o[4 * i + 1] *= alpha0;\n"
        "      o[4 * i + 2] *= alpha1;\n      o[4 * i + 3] *= alpha1;\n",
        "",
        "fails (a) and LM_TOL"),
    "truncating bf16 store": (
        "= __floats2bfloat162_rn(a, b);",
        "= __halves2bfloat162(__float2bfloat16_rz(a), "
        "__float2bfloat16_rz(b));",
        "fails (b) only (about -0.5 ulp); passes (a), (c) and LM_TOL"),
    "stage released before its P.V wgmma is waited on": (
        "    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(o);\n"
        "    if (tid == 0) mbar_arrive(empty(s));",
        "    wgmma_commit();\n    if (tid == 0) mbar_arrive(empty(s));\n"
        "    wgmma_wait_all();\n    fence_regs(o);",
        "a race: the producer's next TMA may overwrite V while the wgmma "
        "reads it; caught by (c) only if it lands in some tile of the two "
        "launches, which is not certain"),
}


# planted at (192, 128) only: each is a no-op where DK == DV <= 128
MLA_FAULTS = {
    "Q.K^T stops after two of its three 64-column boxes": (
        "for (int kk = 0; kk < DK / 16; ++kk) {",
        "for (int kk = 0; kk < (DK > 128 ? 128 : DK) / 16; ++kk) {",
        "fails (a): the scores lose a third of each dot product"),
    "the second V box is never loaded": (
        "        mbar_expect_tx(v_full(s), S::V);\n"
        "        for (int b = 0; b < V_BOXES; ++b)",
        "        mbar_expect_tx(v_full(s), DK != DV ? S::V - BOX_KV : S::V);\n"
        "        for (int b = 0; b < (DK != DV ? V_BOXES - 1 : V_BOXES); ++b)",
        "fails (a): output columns 64-127 are P times whatever that shared "
        "memory held; likely (c) too"),
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
        "output), a third of the output is never written"),
}

RACES = {"stage released before its P.V wgmma is waited on"}
ALL_FAULTS = {**FAULTS, **MLA_FAULTS}


def build_faults(tmp: Path):
    """One nvcc per faulty copy, all started together; {name: .so}."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for i, (name, (old, new, _)) in enumerate(ALL_FAULTS.items()):
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
    """q, k, v on the card at the shape the check of ``widths`` uses."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    if widths == (128, 128):
        B, H, Kh = 1, 40, 10
    else:
        B, H, Kh = 1, 16, 16

    def rnd(heads, d):
        return torch.randn((B, heads, smoke.LM_SEQ, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
    return rnd(H, widths[0]), rnd(Kh, widths[0]), rnd(Kh, widths[1])


def kernel_checks(kernels, widths, label):
    """{kernel name: passes} of ``flash_bf16_check`` at ``widths``."""
    q, k, v = inputs(widths)
    p, den, vf = _parts(q, k, v, True)
    want = torch.einsum("bhqk,bhkd->bhqd", p, vf).div_(den)
    del p, den, vf
    tol = flash_bf16_tol(q, k, v)
    kernel_ok = {}
    for name, lib in kernels.items():
        use(lib)
        out = flash_attention(q, k, v)
        again = flash_attention(q, k, v)
        torch.cuda.synchronize()
        r = flash_bf16_check(out, again, want, tol)
        kernel_ok[name] = r["ok"]
        print(f"[kernel {widths[0]},{widths[1]}] {name}: max_abs_err "
              f"{r['max_abs_err']:.3e}, (a) worst {r['worst']:.3f} of the "
              f"tolerance, (b) mean signed error {r['bias_ulp']:+.4f} ulp, "
              f"(c) repeatable {r['repeatable']} -> "
              f"{'passes' if r['ok'] else 'fails'} [{label}]", flush=True)
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
    ap.add_argument("--widths", nargs="+", default=["128,128", "192,128"],
                    choices=["128,128", "192,128"],
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
    for name, (_, _, prediction) in ALL_FAULTS.items():
        where = "(192, 128)" if name in MLA_FAULTS else "every width"
        print(f"[predicted] {name} ({where}): {prediction}", flush=True)
    good = build.load("flash_attention")
    checked = {}                     # (kernel name, check) -> passes
    with tempfile.TemporaryDirectory() as tmp:
        faulty = build_faults(Path(tmp))
        for w in widths:
            planted = {n: lib for n, lib in faulty.items()
                       if w == (192, 128) or n not in MLA_FAULTS}
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
