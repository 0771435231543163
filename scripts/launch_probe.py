#!/usr/bin/env python3
"""Where one dry-run cell's per-device counts come from, on the CPU: the
port's cell on ``meta`` DTensors over a fake process group, its FLOPs,
collective link bytes and HBM bytes attributed to the source lines of
``repro_torch`` that dispatched them, and with ``--reference`` the
reference's own cell compiled for as many forced host devices (in a
subprocess, as the device count is fixed at jax's first use) and
counted from its HLO.

    PYTHONPATH=src python3 scripts/launch_probe.py --arch phi3-medium-14b \
        --shape prefill_32k [--mesh 16,16] [--reduced] [--reference]

``--arch`` also takes a GNN cell of the survey (``gat-L3-N128``: its
4096 targets; ``--shape`` is then ignored). ``--reduced`` takes the
reduced config at 64 tokens, batch 8, as the tests' dry-run does. The
reference side needs jax and the reference package; the port side
needs torch only. It checks nothing.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import traceback

_REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
import dataclasses, jax
from jax.sharding import AxisType
from repro.configs.base import SHAPES
from repro.configs.registry import get_config
from repro.launch.cells import build_cell
from repro.launch.hlo_analysis import analyze
dims, names = %r, %r
mesh = jax.make_mesh(dims, names, axis_types=(AxisType.Auto,) * len(dims))
shp = SHAPES[%r]
if %r:
    shp = dataclasses.replace(shp, seq_len=64, global_batch=8)
fn, args, ins, outs, don = build_cell(get_config(%r, reduced=%r), shp, mesh)
with mesh:
    txt = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                  donate_argnums=don).lower(*args).compile().as_text()
s = analyze(txt, n_devices=%d).to_json()
print(json.dumps({k: s[k] for k in ("flops", "collective_link_bytes",
                                    "per_collective")}))
"""


def _site() -> str:
    """The innermost line of ``repro_torch`` outside the analysis and the
    shared helpers of ``models/common.py`` (their callers name the op)."""
    for fr in reversed(traceback.extract_stack()):
        if ("repro_torch" in fr.filename and "launch" not in fr.filename
                and not fr.filename.endswith("common.py")):
            name = fr.filename.split("repro_torch" + os.sep)[-1]
            return f"{name}:{fr.lineno} {(fr.line or '').strip()[:60]}"
    return "?"


def port_counts(arch, shape, dims, names, reduced):
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import op_analysis
    from repro_torch.launch.cells import build_cell, build_gnn_cell
    from repro_torch.launch.dryrun import GNN_CELLS
    from repro_torch.launch.mesh import make_mesh, start_fake_group
    start_fake_group(math.prod(dims))
    mesh = make_mesh(dims, names)
    gnn = {g.display: g for g in GNN_CELLS}
    if arch in gnn:
        fn, args = build_gnn_cell(gnn[arch], mesh)
    else:
        shp = SHAPES[shape]
        if reduced:
            shp = dataclasses.replace(shp, seq_len=64, global_batch=8)
        fn, args = build_cell(get_config(arch, reduced=reduced), shp, mesh)
    flops, links, hbm = (collections.Counter() for _ in range(3))
    add_flops = op_analysis.OpSummary.add_flops
    dispatch = op_analysis._Counter.__torch_dispatch__

    def counted_add(self, f, dtype):
        flops[_site()] += f
        add_flops(self, f, dtype)

    def counted_dispatch(self, func, types, args=(), kwargs=None):
        before = self.s.collective_link_bytes, self.s.hbm_bytes
        out = dispatch(self, func, types, args, kwargs)
        op = func._overloadpacket.__name__
        if self.s.collective_link_bytes > before[0]:
            links[f"{op} {_site()}"] += \
                self.s.collective_link_bytes - before[0]
        if self.s.hbm_bytes > before[1]:
            hbm[f"{op} {_site()}"] += self.s.hbm_bytes - before[1]
        return out

    op_analysis.OpSummary.add_flops = counted_add
    op_analysis._Counter.__torch_dispatch__ = counted_dispatch
    try:
        with op_analysis.counting() as s:
            fn(*args)
    finally:
        op_analysis.OpSummary.add_flops = add_flops
        op_analysis._Counter.__torch_dispatch__ = dispatch
    return s, flops, links, hbm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="serve")
    ap.add_argument("--mesh", default="16,16",
                    help="dims: 2 = (data, model), 3 = (pod, data, model)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    dims = tuple(int(x) for x in args.mesh.split(","))
    names = (("data", "model") if len(dims) == 2
             else ("pod", "data", "model"))
    s, flops, links, hbm = port_counts(args.arch, args.shape, dims, names,
                                  args.reduced)
    print(f"port {args.arch} {args.shape} on {dims}: flops {s.flops:.6g}, "
          f"link bytes {s.collective_link_bytes:.6g} "
          f"{dict(s.link_bytes_by_group)}, by kind {s.per_collective}")
    for title, c in (("flops", flops), ("link bytes", links),
                     ("HBM bytes", hbm)):
        total = sum(c.values()) or 1.0
        print(f"  {title} by site:")
        for site, v in c.most_common(args.top):
            print(f"    {v:.6g} ({100 * v / total:.1f} %) {site}")
    if args.reference:
        n = math.prod(dims)
        code = _REFERENCE % (n, dims, names, args.shape, args.reduced,
                             args.arch, args.reduced, n)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-3000:])
            return out.returncode
        ref = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"reference: flops {ref['flops']:.6g} (port / reference "
              f"{s.flops / ref['flops']:.4f}), link bytes "
              f"{ref['collective_link_bytes']:.6g}, by kind "
              f"{ref['per_collective']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
