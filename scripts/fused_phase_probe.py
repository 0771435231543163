#!/usr/bin/env python3
"""Card probe: where the fused layer's ``tf32x3`` kernel spends its time,
phase by phase.

    python3 scripts/fused_phase_probe.py

Builds a copy of ``src/repro_torch/csrc/fused_gnn.cu`` (in a temporary
directory; the repository is not written) whose two consumer warpgroups
stamp the global timer (``%globaltimer``, ns) at six points of every
block (one item: a subgraph's 64 output columns): its start, the first
k-tile of phase 1 in shared memory, the end of phase 1, HW^T stored, the
end of phase 2, the end of the epilogue; and the SM each block ran on. On ``chip_smoke.py``'s serving batch (C=64, N=256,
seed-0 weights) at the five fp32 rows of ``chip_smoke.fused_rows`` it runs
the copy once to warm up and once stamped, and prints, as medians over the
blocks, each warpgroup's wait for the first k-tile, time a k-tile of phase
1 and of phase 2, HW^T's store and the epilogue, the block's total; the
second warpgroup's lag behind the first at the first k-tile; the kernel's
span; and the gap on an SM from one block's end to the next block's start.
Exits 1 where the copy does not build.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from fused_parent_probe import launch, typed  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

STAMPS = 8          # per warpgroup and block: six times, the SM, unused
HEAD = """
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define STAMP(i) do { if ((threadIdx.x & 127) == 0) { \\
  unsigned long long* g = g_stamps + ((blockIdx.y * gridDim.x + blockIdx.x) \\
      * 2 + threadIdx.x / 128 - 1) * 8; \\
  g[i] = gtime(); if ((i) == 0) g[6] = smid(); } } while (0)
"""
TAIL = """
extern "C" int fused_stamps(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, n * 8));
}
"""
# (text of the kernel source, what replaces it): each occurs once
EDITS = (
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + HEAD),
    ("    for (int i = 0; i < 32; ++i) an[mt][i] = as[mt][i] = 0.0f;\n\n"
     "  for (int kt = 0; kt < kt1; ++kt) {\n"
     "    const int s = kt % STAGES;\n"
     "    mbar_wait(full1(s), (kt / STAGES) & 1);\n",
     "    for (int i = 0; i < 32; ++i) an[mt][i] = as[mt][i] = 0.0f;\n"
     "  STAMP(0);\n\n"
     "  for (int kt = 0; kt < kt1; ++kt) {\n"
     "    const int s = kt % STAGES;\n"
     "    mbar_wait(full1(s), (kt / STAGES) & 1);\n"
     "    if (kt == 0) STAMP(1);\n"),
    ("  if (NEIGH) {\n    // HW leaves the registers",
     "  STAMP(2);\n  if (NEIGH) {\n    // HW leaves the registers"),
    ("    bar_sync(1, 256);                             // HW^T whole\n\n"
     "    for (int j = 0; j < kt2; ++j) {\n",
     "    bar_sync(1, 256);                             // HW^T whole\n"
     "    STAMP(3);\n\n"
     "    for (int j = 0; j < kt2; ++j) {\n"),
    ("  // epilogue: the tile goes through shared memory (ring 1, read by no"
     " one", "  STAMP(4);\n  // epilogue: the tile goes through shared memory"
     " (ring 1, read by no one"),
    ("  epilogue(sm, as, r0, t, n0, c, N, Fout, act, bias, mask, out);\n}\n",
     "  epilogue(sm, as, r0, t, n0, c, N, Fout, act, bias, mask, out);\n"
     "  STAMP(5);\n}\n"),
)


def stamped_copy(tmp: Path):
    text = (build.CSRC / "fused_gnn.cu").read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in the kernel source once")
        text = text.replace(old, new)
    cu, so = tmp / "stamped.cu", tmp / "stamped.so"
    cu.write_text(text + TAIL)
    p = subprocess.run(build.nvcc_command(cu, so), capture_output=True,
                       text=True)
    if p.returncode:
        raise RuntimeError(f"the stamped copy does not build:\n{p.stderr}")
    lib = typed(ctypes.CDLL(str(so)))
    lib.fused_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_stamps.restype = ctypes.c_int
    return lib


def med(x) -> str:
    return f"{float(np.median(x)) / 1e3:.2f}"


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    _, _, sb = smoke.serving_batch()
    x = smoke.gnn_inputs(sb, torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        lib = stamped_copy(Path(tmp))
        for tag, a, kw in smoke.fused_rows(x):
            act = kw.get("act", "relu")
            C, N, Fin = a[1].shape
            Fout = (a[2] if a[2] is not None else a[3]).shape[1]
            blocks = C * ((Fout + 63) // 64)
            launch(lib, a, act, split=True)
            torch.cuda.synchronize()
            launch(lib, a, act, split=True)
            torch.cuda.synchronize()
            buf = np.zeros(blocks * 2 * STAMPS, np.uint64)
            err = lib.fused_stamps(buf.ctypes.data, buf.size)
            if err:
                raise RuntimeError(f"fused_stamps failed ({err})")
            s = buf.reshape(blocks, 2, STAMPS).astype(np.int64)
            kt1, kt2 = -(-Fin // 32), (-(-N // 32) if a[2] is not None
                                       else 0)
            t = s[..., :6] - s[:, :1, :1]       # from WG0's start
            parts = []
            for wg in (0, 1):
                w = t[:, wg]
                text = (f"WG{wg}: first k-tile {med(w[:, 1] - w[:, 0])}, "
                        f"phase 1 {med((w[:, 2] - w[:, 1]) / kt1)} a k-tile")
                if kt2:
                    text += (f", HW^T {med(w[:, 3] - w[:, 2])}, phase 2 "
                             f"{med((w[:, 4] - w[:, 3]) / kt2)} a k-tile")
                text += (f", epilogue {med(w[:, 5] - w[:, 4])}, block "
                         f"{med(w[:, 5] - w[:, 0])}")
                parts.append(text)
            lag = t[:, 1, 1] - t[:, 0, 1]
            start, end = s[:, 0, 0], s[:, :, 5].max(1)
            sm = s[:, 0, 6]
            gaps = []
            for k in np.unique(sm):
                idx = np.where(sm == k)[0]
                order = idx[np.argsort(start[idx])]
                gaps += list(start[order[1:]] - end[order[:-1]])
            print(f"[phase] {tag}: us, medians over {blocks} blocks; "
                  f"{'; '.join(parts)}; WG1 behind WG0 at its first k-tile "
                  f"{med(lag)}; kernel span "
                  f"{(end.max() - start.min()) / 1e3:.2f}, blocks on an SM "
                  f"{np.bincount(np.unique(sm, return_inverse=True)[1]).max()}"
                  f" at most, gap between them {med(gaps) if gaps else '-'} "
                  f"[{label}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
