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
the template that only (192, 128) runs now (``TEMPLATE``; its third
64-column box of Q and K, its V stage narrower than K's, its output's row
stride DV among them), what only the D=64 kernel runs (its overlapped
Q.K^T, its rescale after P.V, its last P.V, its per-warpgroup tile count),
what only the D=128 kernel runs (its rescale after the add, its last P.V,
its double-buffered Q, its persistent walk, its V release), and the bf16
store all of them share. A fault is one or
more edits of the source. No fault leaves a barrier waiting for bytes that
never come, and none writes outside the output. Before each launch the
check fills, and frees, a block of the output's size with NaN, so that
the output (allocated by the wrapper and never cleared) does not inherit
the last kernel's values where a fault leaves rows unwritten.

Prints each fault's prediction (written before its first run), then one
line per kernel, width, shape and check with the reading and the verdict.
Exits 1 unless the unchanged kernel passes every check and every planted
fault fails (a), (b) or (c) at some shape of each width it is planted at,
except those of ``RACES``: whether a race shows in the output depends on
timing no check controls, so their verdicts, caught or not, are printed
and do not decide the exit code.
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

TEMPLATE = ((192, 128),)
W128 = ((128, 128),)
ALL = ((64, 64), (128, 128), (192, 128))

# name -> (text of the kernel source, what replaces it, prediction, the
# (q/k, v) widths whose code it reaches); a fault of several edits gives
# tuples of texts and replacements
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
        "        for (int e = 0; e < 8; ++e) {\n"
        "          o[4 * e] *= alpha[0];\n          o[4 * e + 1] *= alpha[0];\n"
        "          o[4 * e + 2] *= alpha[1];\n"
        "          o[4 * e + 3] *= alpha[1];\n",
        "        for (int e = 0; e < 8; ++e) {\n",
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

W128_RESCALE = (
    "#pragma unroll\n      for (int e = 0; e < 16; ++e) {\n"
    "        o[4 * e] *= alpha[0];\n        o[4 * e + 1] *= alpha[0];\n"
    "        o[4 * e + 2] *= alpha[1];\n        o[4 * e + 3] *= alpha[1];\n"
    "      }\n")
W128_V_RELEASE = ("      if (lead) mbar_arrive(v_empty(sp));         // release V "
                  "of tile j - 1\n")
FAULTS.update({
    # what only the D=128 kernel runs
    "D=128: O rescaled before the add, not after": (
        ("      qk(sc, sq, sK + s * TILE);\n      pv(o, p, sV + sp * TILE);\n",
         W128_V_RELEASE + W128_RESCALE),
        ("      qk(sc, sq, sK + s * TILE);\n" + W128_RESCALE
         + "      pv(o, p, sV + sp * TILE);\n", W128_V_RELEASE),
        "fails (a) and LM_TOL: O = O alpha_{j-1} + P_{j-1} V_{j-1} leaves "
        "the last tile's alpha unapplied, so every row whose maximum rises "
        "in its last tile sums its older tiles too large", W128),
    "D=128: the last tile's P.V dropped": (
        "    if (turns) bar_sync(TURN + cw, 256);\n"
        "    pv(o, p, sV + s * TILE);\n",
        "    if (turns) bar_sync(TURN + cw, 256);\n",
        "fails (a) and LM_TOL: each row loses its last tile's values (its "
        "diagonal, when causal)", W128),
    "D=128: the other Q buffer read from a block's third item on": (
        "const uint32_t sq = sQ + b * TILE + cw * 64 * 128;",
        "const uint32_t sq = sQ + ((b + (r >= QBUF)) % QBUF) * TILE + "
        "cw * 64 * 128;",
        "fails (a) and LM_TOL: from its third item on, a block scores its "
        "keys against the Q rows of the item before or after", W128),
    "D=128: the persistent walk stops a round early": (
        "return i < n_items ? i : -1;",
        "return i < n_items && (r + 1) * grid < n_items ? i : -1;",
        "fails (a): the last round's items (52 at phi3's shape: the first "
        "256 rows of 12 heads, the first 128 of the other 40) are never "
        "written and read the NaN left in their memory; likely LM_TOL",
        W128),
    "D=128: V released before its P.V is waited on": (
        "      wgmma_wait<0>();                            // P_{j-1} "
        "V_{j-1} done\n      fence_regs(o);\n      fence_regs(p);\n"
        "      if (lead) mbar_arrive(v_empty(sp));         // release V of "
        "tile j - 1\n",
        "      if (lead) mbar_arrive(v_empty(sp));         // release V of "
        "tile j - 1\n      wgmma_wait<0>();                            // "
        "P_{j-1} V_{j-1} done\n      fence_regs(o);\n      "
        "fence_regs(p);\n",
        "a race: the producer, waiting on that stage, may load tile j + 1's "
        "V over tile j - 1's while P.V still reads it; caught by (a) or (c) "
        "only if the load lands first, which is likely (the producer is "
        "already waiting) but not certain", W128),
})

RACES = {"stage released before its P.V wgmma is waited on",
         "D=64: stage released before its P.V is waited on",
         "D=128: V released before its P.V is waited on"}


def build_faults(tmp: Path, edits=None):
    """One nvcc per copy of the kernel source, each with the edits of one
    entry of ``edits`` ({name: (text, replacement, ...)}, ``FAULTS`` when
    None; tuples of texts and replacements for several edits, empty tuples
    for none), all started together; {name: (library, ptxas report)}."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for i, (name, (old, new, *_)) in enumerate(
            (FAULTS if edits is None else edits).items()):
        text = src
        for o, n in zip(*((old, new) if isinstance(old, tuple)
                          else ((old,), (new,)))):
            if text.count(o) != 1:
                raise RuntimeError(f"{name!r}: its text is not in the "
                                   f"kernel source once")
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
        libs[name] = (ctypes.CDLL(str(so)), out + err)
    return libs


def launch(lib, q, k, v, causal=True):
    """``lib``'s wgmma kernel on q [B,H,S,D], k [B,Kh,S,D], v [B,Kh,S,Dv]
    by a direct ``ctypes`` call on the current stream (the wrapper's checks
    left out); returns the new output."""
    fwd = lib.flash_attention_wgmma_fwd
    if fwd.argtypes is None:                     # once a library
        vp, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, ctypes.c_float,
                        i, vp]
    B, H, S, D = q.shape
    out = q.new_empty((B, H, S, v.shape[-1]))
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
              k.shape[1], S, k.shape[2], D, v.shape[-1], 1.0 / D ** 0.5,
              int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"a kernel launch failed (error {err})")
    return out


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


def poisoned(call, shape):
    """``call()`` after a bf16 block of ``shape`` has been filled with NaN
    and freed: the caching allocator hands the same block to the output the
    call allocates next, so rows a kernel leaves unwritten read NaN."""
    torch.full(tuple(shape), float("nan"), dtype=torch.bfloat16,
               device="cuda")
    return call()


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
            out = poisoned(lambda: flash_attention(q, k, v, causal=causal),
                           want.shape)
            again = poisoned(lambda: flash_attention(q, k, v,
                                                     causal=causal),
                             want.shape)
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
        faulty = {n: lib for n, (lib, _) in build_faults(Path(tmp)).items()}
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
