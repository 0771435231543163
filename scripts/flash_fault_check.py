#!/usr/bin/env python3
"""Control readings for the checks that hold ``flash_attention`` on a GPU.

    python3 scripts/flash_fault_check.py

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one fault
planted in each (in a temporary directory; the repository is not written),
and runs the unchanged kernel and each faulty one through the two checks
of ``chip_smoke.py`` that reach it, with that script's tolerances:

- the kernel against its plain version at the prefill's shape (B=1, H=40,
  S=8192, D=128, bf16, causal): ``FLASH_BF16_TOL`` and
  ``FLASH_BF16_EQUAL``;
- phi3-medium-14b at full width, 8 layers, one 8192-token prompt:
  ``prefill(impl="cuda")`` through the kernel against
  ``prefill(impl="torch")``, at ``LM_TOL``.

Prints one line per kernel and check with the reading and the verdict.
Exits 1 unless the unchanged kernel passes both checks and every planted
fault fails the kernel check.
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
    flash_attention, flash_attention_ref)
from repro_torch.models import transformer  # noqa: E402

# name -> (text of the kernel source, what replaces it)
FAULTS = {
    "skip the diagonal tile": (
        "const int k_end = causal ? min(Sk, q_last + 1) : Sk;",
        "const int k_end = causal ? min(Sk, q0) : Sk;"),
    "p scaled by 0.9 in P.V": (
        "const float pv[4] = {pa.x, pa.y, pa.z, pa.w};",
        "const float pv[4] = {0.9f * pa.x, 0.9f * pa.y, 0.9f * pa.z, "
        "0.9f * pa.w};"),
    "no rescale of the accumulator by alpha": (
        "acc[i][c] *= alpha;", "acc[i][c] *= 1.0f;"),
    "truncating bf16 store": (
        "*p = __float2bfloat16(x);", "*p = __float2bfloat16_rz(x);"),
}


def build_faults(tmp: Path):
    """One nvcc per faulty copy, all started together; {name: .so}."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for i, (name, (old, new)) in enumerate(FAULTS.items()):
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name!r}: its text is not in the "
                               f"kernel source once")
        cu, so = tmp / f"fault{i}.cu", tmp / f"fault{i}.so"
        cu.write_text(src.replace(old, new))
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"fault {name!r} does not build:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def use(lib) -> None:
    """Makes ``flash_attention`` launch the kernel of ``lib``."""
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
    good = build.load("flash_attention")
    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"unchanged kernel": good, **build_faults(Path(tmp))}

        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((1, 40, smoke.LM_SEQ, 128), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        want = flash_attention_ref(q, k, v)
        kernel_ok = {}
        for name, lib in kernels.items():
            use(lib)
            err, worst, share = smoke.closeness(flash_attention(q, k, v),
                                                want, smoke.FLASH_BF16_TOL)
            kernel_ok[name] = ok = (worst <= 1.0
                                    and share >= smoke.FLASH_BF16_EQUAL)
            print(f"[kernel] {name}: max_abs_err {err:.3e}, worst "
                  f"{worst:.3f} of the tolerance, bitwise equal "
                  f"{share:.6f} -> {'passes' if ok else 'fails'} "
                  f"[{label}]", flush=True)
        del q, k, v, want

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
    ok = (kernel_ok["unchanged kernel"] and lm_ok["unchanged kernel"]
          and not any(kernel_ok[n] for n in faults))
    print(f"[summary] unchanged kernel passes both: "
          f"{kernel_ok['unchanged kernel'] and lm_ok['unchanged kernel']}; "
          f"faults caught by the kernel check: "
          f"{sum(not kernel_ok[n] for n in faults)} of {len(faults)}, by "
          f"LM_TOL: {sum(not lm_ok[n] for n in faults)} of {len(faults)}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
