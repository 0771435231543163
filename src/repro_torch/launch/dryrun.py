"""Dry-run of every (architecture x input-shape) cell on the single-pod
16x16 mesh and the 2x16x16 multi-pod mesh, the counterpart of
``repro.launch.dryrun``: run each cell's step once on ``meta`` DTensors
over a fake process group and record, as JSON, its memory, its FLOPs and
the roofline terms of ``launch.op_analysis`` per device.

The reference forces 512 host devices and compiles each cell without
running it. Here ``torch.distributed``'s "fake" process group stands for
the ranks (this process is rank 0; collectives do nothing) and the tensors
are ``meta`` (no memory, no arithmetic): the step runs op by op at the
shapes of one rank's shards. That is the counterpart of the forced host
devices, not a fallback: no sharded step runs on a card in either
package. One process holds one group, so a run takes one mesh kind
(``--mesh single`` or ``multi``; ``both`` runs each in a subprocess).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single  # all
  ... --arch deepseek-7b --shape train_4k --mesh single             # one
  ... --gnn                                                    # GNN cells
  ... --out build/dryrun_torch --skip-existing                 # resumable
  ... --test-mesh 2,4 --reduced       # small meshes and reduced configs
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

from repro_torch.configs.base import SHAPES, optimized, shape_cells
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.gnn.model import GNNConfig
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import MULTI, SINGLE

GNN_CELLS = [GNNConfig(kind=k, n_layers=L, receptive_field=N, f_in=512)
             for (k, L, N) in
             [("gcn", 3, 128), ("sage", 5, 128), ("gat", 3, 128),
              ("sage", 16, 256), ("gcn", 8, 64)]]


def run_cell(fn, args, n_devices: int) -> dict:
    """Run ``fn(*args)`` once under the op analysis; the record of the
    reference's keys (``t_run_s`` for its lower and compile times). The
    memory is rank 0's: its argument shards, its outputs (an output that
    is a donated argument counts as ``alias_bytes``) and the peak of what
    the step allocates beyond its new outputs (``temp_bytes``)."""
    donated = set()
    for i in getattr(fn, "donate", ()):
        donated |= op_analysis.storages(args[i])
    arg_bytes = op_analysis.local_bytes(args)
    t0 = time.time()
    with op_analysis.counting() as s:
        out = fn(*args)
    t_run = time.time() - t0
    out_bytes = op_analysis.local_bytes(out)
    alias = _alias_bytes(out, donated)
    temp = max(0, s.peak_live_bytes - (out_bytes - alias))
    return {
        "ok": True,
        "t_run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_bytes_est": arg_bytes + out_bytes - alias + temp,
        },
        "cost_analysis": {"flops": s.flops},
        "hlo": s.to_json(),
        "n_devices": n_devices,
    }


def _alias_bytes(out, donated) -> int:
    from torch.utils._pytree import tree_flatten
    n = 0
    seen = set()
    for t in tree_flatten(out)[0]:
        local = getattr(t, "_local_tensor", t)
        if not hasattr(local, "untyped_storage"):
            continue
        sid = op_analysis.id_storage(local)
        if sid in donated and sid not in seen:
            seen.add(sid)
            n += local.numel() * local.element_size()
    return n


def cell_name(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}__{shape}__{mesh_kind}".replace("/", "_")


def _cells(args):
    cells = []
    if not args.gnn_only:
        archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
        for arch in archs:
            cfg = get_config(arch, reduced=args.reduced)
            if args.variant == "opt":
                cfg = optimized(cfg)
            shapes = (shape_cells(cfg) if args.shape == "all"
                      else [SHAPES[s] for s in args.shape.split(",")])
            for shp in shapes:
                if args.reduced:
                    shp = _reduced_shape(shp)
                cells.append(("lm", arch, cfg, shp))
    if args.gnn or args.gnn_only:
        for g in GNN_CELLS:
            cells.append(("gnn", g.display, g, None))
    return cells


def _reduced_shape(shp):
    """A reduced config's cell: its kind at 64 tokens, batch 8."""
    import dataclasses
    return dataclasses.replace(shp, seq_len=64, global_batch=8)


def run_mesh(args, mesh_kind: str, shape, axes) -> list:
    """Every cell on one mesh in this process; the failed cells' names."""
    from repro_torch.launch.cells import build_cell, build_gnn_cell
    from repro_torch.launch.mesh import make_mesh, start_fake_group
    n = math.prod(shape)
    start_fake_group(n)
    mesh = make_mesh(shape, axes)
    failures = []
    for kind, arch, cfg, shp in _cells(args):
        sname = shp.name if shp else "serve"
        if args.variant != "base":
            sname += "." + args.variant
        name = cell_name(arch, sname, mesh_kind)
        path = os.path.join(args.out, name + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {name}")
            continue
        print(f"[cell] {name} ...", flush=True)
        try:
            if kind == "lm":
                fn, a = build_cell(cfg, shp, mesh)
            else:
                fn, a = build_gnn_cell(cfg, mesh, C=args.gnn_batch,
                                       variant=args.variant)
            rec = run_cell(fn, a, n)
        except Exception as e:   # noqa: BLE001 - the survey must go on
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            failures.append(name)
        rec.update(arch=arch, shape=sname, mesh=mesh_kind, n_devices=n,
                   mesh_shape=list(shape), kind=kind,
                   reduced=bool(args.reduced))
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["ok"]:
            mm = rec["memory"]
            print(f"  ok: run {rec['t_run_s']}s, "
                  f"args {mm['argument_bytes']/2**30:.2f} GiB, "
                  f"temp {mm['temp_bytes']/2**30:.2f} GiB, "
                  f"flops {rec['hlo']['flops']:.3e}", flush=True)
        else:
            print(f"  FAIL: {rec['error']}", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch name(s), comma-separated | all (LM archs)")
    ap.add_argument("--shape", default="all",
                    help="shape name(s), comma-separated | all (each "
                         "arch's shape cells)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--gnn", action="store_true",
                    help="also run the GNN serve cells")
    ap.add_argument("--gnn-only", action="store_true")
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"],
                    help="opt = beyond-paper optimizations "
                         "(chunked attention, gather MoE, cache CP)")
    ap.add_argument("--test-mesh", default="",
                    help="comma-separated dims in place of the production "
                         "mesh, e.g. 2,4 (data, model) or 2,2,2 (pod, "
                         "data, model)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs at 64 tokens, batch 8")
    ap.add_argument("--gnn-batch", type=int, default=None,
                    help="targets a GNN cell (default GNN_SERVE_BATCH)")
    args = ap.parse_args(argv)
    if args.gnn_batch is None:
        from repro_torch.launch.cells import GNN_SERVE_BATCH
        args.gnn_batch = GNN_SERVE_BATCH
    os.makedirs(args.out, exist_ok=True)

    if args.test_mesh:
        dims = tuple(int(x) for x in args.test_mesh.split(","))
        axes = SINGLE[1] if len(dims) == 2 else MULTI[1]
        kind = "x".join(map(str, dims))
        failures = run_mesh(args, kind, dims, axes)
    elif args.mesh == "both":
        # one process a mesh: a process holds one fake group
        failures = []
        for kind in ("single", "multi"):
            rc = subprocess.call([sys.executable, "-m",
                                  "repro_torch.launch.dryrun",
                                  *_argv_for(argv, kind)])
            if rc:
                failures.append(kind)
    else:
        shape, axes = SINGLE if args.mesh == "single" else MULTI
        failures = run_mesh(args, args.mesh, shape, axes)
    print(f"\ndone. {len(failures)} failures: {failures}")
    return 1 if failures else 0


def _argv_for(argv, kind):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--mesh" in argv:
        i = argv.index("--mesh")
        del argv[i:i + 2]
    return argv + ["--mesh", kind]


if __name__ == "__main__":
    raise SystemExit(main())
