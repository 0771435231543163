#!/usr/bin/env python3
"""Where the time of ``gat_attention``'s slab kernel goes, phase by phase.

    python3 scripts/gat_phase_probe.py [--structure batch|identity|empty|dense]
                                        [--fused]

Builds a copy of ``src/repro_torch/csrc/gat_attention.cu`` (in a temporary
directory; the repository is not written) in which lane 0 of every warp of
the slab kernel reads the SM's cycle counter (``clock64``) at five points
and the global timer (``%globaltimer``, ns) at the first and the last:

    0 start   1 this warp's structure rows packed   2 z landed (barrier)
    3 non-finite scan (and the fused form's scores) done (barrier)
    4 all of this warp's rows written

and launches it on the serving batch (C=64, N=256, F=256, 4 heads, the
Flickr-sized graph's first engine batch, the inputs of ``chip_smoke.py``'s
``gat_rows``); ``--structure`` swaps the batch's structure for the identity
(one entry a row), none, or every entry, to part the rows phase's time
into what a row costs and what an entry costs. ``--fused`` launches the
fused form (``gat_attention_layer``: the structure from the batch's
adj_mean and mask, the scores from the slab, the tail before the store) on
``chip_smoke.py``'s ``gat_layer_args`` at C=64 instead (``--structure``
does not apply). Prints the median and the
largest of each phase over the blocks (a block's phase lasts from its first
warp's start to its last warp's end), the kernel's span on the global
timer, how many blocks were running at once, the kernel's device time from
``torch.profiler``, and the call's time on CUDA events for comparison.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gat_attention as gat  # noqa: E402

STAMPS = 7                  # five clock64 readings, two globaltimer readings
MAX_WARPS = 1 << 16

PRELUDE = """
__device__ unsigned long long probe_stamps[%d];
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) if (lane == 0) probe_stamps[((blockIdx.y * gridDim.x + \\
    blockIdx.x) * SLAB_WARPS + warp) * %d + (k)] = clock64();
#define STAMP_NS(k) if (lane == 0) probe_stamps[((blockIdx.y * gridDim.x + \\
    blockIdx.x) * SLAB_WARPS + warp) * %d + (k)] = probe_ns();
""" % (MAX_WARPS * STAMPS, STAMPS, STAMPS)

# (text in the kernel, what replaces it): each text must occur once
PLANTS = [
    ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n\n"
     "  // staging",
     "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
     "  STAMP_NS(5) STAMP(0)\n\n  // staging"),
    ("  cp_async_wait_all();\n  __syncthreads();\n",
     "  STAMP(1)\n  cp_async_wait_all();\n  __syncthreads();\n  STAMP(2)\n"),
    ("  const bool any_bad = *flag != 0;\n",
     "  const bool any_bad = *flag != 0;\n  STAMP(3)\n"),
    ("    __syncwarp();                      // lst is rewritten for the "
     "next row\n  }\n}\n",
     "    __syncwarp();                      // lst is rewritten for the "
     "next row\n  }\n  STAMP(4) STAMP_NS(6)\n}\n"),
    ("extern \"C\" {\n",
     "extern \"C\" {\n\nint probe_read(unsigned long long* host, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
     "      host, probe_stamps, sizeof(unsigned long long) * n));\n}\n"),
]


def slab_warps() -> int:
    """The slab kernel's warps a block, from its source."""
    src = (build.CSRC / "gat_attention.cu").read_text()
    return int(re.search(r"constexpr int SLAB_WARPS = (\d+);", src).group(1))


def instrumented(tmp: Path) -> ctypes.CDLL:
    src = (build.CSRC / "gat_attention.cu").read_text()
    for old, new in PLANTS:
        if src.count(old) != 1:
            raise RuntimeError(f"probe: {old!r} is not in the kernel once")
        src = src.replace(old, new)
    src = src.replace("namespace {\n", "namespace {\n" + PRELUDE, 1)
    cu, so = tmp / "gat_probe.cu", tmp / "gat_probe.so"
    cu.write_text(src)
    p = subprocess.run(build.nvcc_command(cu, so), capture_output=True,
                       text=True)
    if p.returncode:
        raise RuntimeError(f"probe does not build:\n{p.stderr}")
    return ctypes.CDLL(str(so))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--structure", default="batch",
                    choices=("batch", "identity", "empty", "dense"))
    ap.add_argument("--fused", action="store_true")
    opts = ap.parse_args(argv)
    structure = opts.structure
    if not torch.cuda.is_available():
        print("gat_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    label = smoke.card()
    print(f"[env] {label}; torch {torch.__version__}", flush=True)
    _, _, sb = smoke.serving_batch()
    x = smoke.gnn_inputs(sb, torch.device("cuda"))
    tag, args = smoke.gat_rows(x)[0]
    heads = args[1].shape[-1]
    call = lambda: gat.gat_attention(*args, n_heads=heads)  # noqa: E731
    if opts.fused:
        args = smoke.gat_layer_args(x, smoke.C)
        tag = f"{tag.split(' struct_nnz')[0]} fused"
        call = lambda: gat.gat_attention_layer(  # noqa: E731
            *args, n_heads=heads)
    elif structure != "batch":
        st = args[3]
        eye = torch.eye(smoke.N, device=st.device).expand_as(st)
        st = {"identity": eye, "empty": torch.zeros_like(st),
              "dense": torch.ones_like(st)}[structure].contiguous()
        args = (*args[:3], st)
        tag = f"{tag.split(' struct_nnz')[0]} structure={structure}"
    before = gat.variant_launches["slab"]
    good = call()
    if gat.variant_launches["slab"] != before + 1:
        raise RuntimeError(f"probe: the serving shape took another kernel "
                           f"than the slab kernel ({gat.variant_launches})")
    ms = smoke.cuda_ms(call, iters=50)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    device = {re.search(r"gat_\w+_kernel", e.key).group(0):
              e.self_device_time_total / e.count / 1e3
              for e in prof.key_averages()
              if e.self_device_time_total > 0
              and re.search(r"gat_\w+_kernel", e.key)}
    with tempfile.TemporaryDirectory() as tmp:
        lib = instrumented(Path(tmp))
        build._libs["gat_attention"] = lib
        try:
            for _ in range(3):
                got = call()
            torch.cuda.synchronize()
            blocks = smoke.C * heads          # one 64-column slice a head
            warps = slab_warps()
            n = blocks * warps * STAMPS
            buf = (ctypes.c_ulonglong * n)()
            err = lib.probe_read(buf, n)
        finally:
            del build._libs["gat_attention"]
    if err:
        raise RuntimeError(f"probe: cudaMemcpyFromSymbol failed ({err})")
    if not torch.equal(got, good):
        raise RuntimeError("probe: the instrumented kernel changed the output")
    s = np.frombuffer(buf, dtype=np.uint64).reshape(blocks, warps, STAMPS)
    s = s.astype(np.float64)
    ghz = float(np.median((s[:, :, 4] - s[:, :, 0])
                          / (s[:, :, 6] - s[:, :, 5])))
    first, last = s[:, :, 0].min(1), s[:, :, 4].max(1)
    phases = {
        "staging (+ structure, if packed first) (start -> stamp 1)":
            s[:, :, 1].max(1) - first,
        "wait for z (-> barrier)": s[:, :, 2].max(1) - s[:, :, 1].max(1),
        "non-finite scan (+ scores, fused)":
            s[:, :, 3].max(1) - s[:, :, 2].max(1),
        "rows (barrier -> last warp done)": last - s[:, :, 3].max(1),
        "rows, the median warp": np.median(s[:, :, 4] - s[:, :, 3], 1),
        "whole block": last - first,
    }
    print(f"[probe] {tag}: CUDA events {ms:.4f} ms a call; device time a "
          f"launch (torch.profiler) "
          f"{', '.join(f'{k} {v:.4f} ms' for k, v in device.items())}; SM "
          f"clock {ghz:.3f} GHz (clock64 over globaltimer) [{label}]",
          flush=True)
    for name, cyc in phases.items():
        us = cyc / ghz / 1e3
        print(f"[probe]   {name}: median {statistics.median(us):.2f} us, "
              f"max {us.max():.2f} us over {blocks} blocks", flush=True)
    t0, t1 = s[:, :, 5].min(1), s[:, :, 6].max(1)
    span = (t1.max() - t0.min()) / 1e3
    grid = np.linspace(t0.min(), t1.max(), 200)
    live = max(int(((t0 <= g) & (t1 >= g)).sum()) for g in grid)
    print(f"[probe]   kernel span on the global timer {span:.2f} us; at "
          f"most {live} blocks running at once; last block started "
          f"{(t0.max() - t0.min()) / 1e3:.2f} us after the first", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
