#!/usr/bin/env python3
"""Control readings for the checks that hold ``flash_attention``'s wgmma
kernel on a GPU.

    python3 scripts/flash_fault_check.py

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one fault
planted in the wgmma kernel of each (in a temporary directory; the
repository is not written), and runs the unchanged kernel and each faulty
one through the two checks of ``chip_smoke.py`` that reach it:

- the kernel against its plain version at the prefill's shape (B=1, H=40,
  10 KV heads, S=8192, D=128, bf16, causal): ``flash_bf16_check``, that is
  (a) every element within ``flash_bf16_tol``, (b) the mean signed error
  within 0.1 bf16 ulp, (c) two launches bitwise equal;
- phi3-medium-14b at full width, 8 layers, one 8192-token prompt:
  ``prefill(impl="cuda")`` through the kernel against
  ``prefill(impl="torch")``, at ``LM_TOL``.

Prints each fault's prediction (written before its first run), then one
line per kernel and check with the reading and the verdict. Exits 1 unless
the unchanged kernel passes both checks and every planted fault fails
(a), (b) or (c), except a race (``RACES``): whether a race shows in the
output depends on timing no check controls, so its verdict, caught or not,
is printed and does not decide the exit code.
"""
from __future__ import annotations

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


RACES = {"stage released before its P.V wgmma is waited on"}


def build_faults(tmp: Path):
    """One nvcc per faulty copy, all started together; {name: .so}."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for i, (name, (old, new, _)) in enumerate(FAULTS.items()):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fault_check: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (_, _, prediction) in FAULTS.items():
        print(f"[predicted] {name}: {prediction}", flush=True)
    good = build.load("flash_attention")
    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"unchanged kernel": good, **build_faults(Path(tmp))}

        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((1, 40, smoke.LM_SEQ, 128), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((1, 10, smoke.LM_SEQ, 128), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
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
            print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3e}, "
                  f"(a) worst {r['worst']:.3f} of the tolerance, (b) mean "
                  f"signed error {r['bias_ulp']:+.4f} ulp, (c) repeatable "
                  f"{r['repeatable']} -> "
                  f"{'passes' if r['ok'] else 'fails'} [{label}]",
                  flush=True)
            del out, again
        del q, k, v, want, tol

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
    use(good)
    faults = [n for n in kernels if n != "unchanged kernel"]
    gating = [n for n in faults if n not in RACES]
    ok = (kernel_ok["unchanged kernel"] and lm_ok["unchanged kernel"]
          and not any(kernel_ok[n] for n in gating))
    print(f"[summary] unchanged kernel passes both: "
          f"{kernel_ok['unchanged kernel'] and lm_ok['unchanged kernel']}; "
          f"faults caught by the kernel check: "
          f"{sum(not kernel_ok[n] for n in gating)} of {len(gating)}, by "
          f"LM_TOL: {sum(not lm_ok[n] for n in gating)} of {len(gating)}",
          flush=True)
    for n in faults:
        if n in RACES:
            print(f"[summary] race {n!r}: "
                  f"{'caught' if not kernel_ok[n] else 'NOT CAUGHT'} by the "
                  f"kernel check (reported; does not decide the exit code)",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
