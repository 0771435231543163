#!/usr/bin/env python3
"""Float32 rounding of the offline precompute build, on the card.

    python3 scripts/tier_precision_probe.py [--layers 5] [--kinds gcn,sage]

The layer-major build (``precompute/propagate.py``) sums each vertex's
in-edges in float32: in edge order on the scatter-gather kernel under
impl="cuda", with ``index_add_`` (atomics, order varying from run to run)
under impl="torch". On the Flickr-sized graph a hub sums up to 18,406
in-edges, against at most a few hundred inside a serving subgraph. For GCN
and GraphSAGE (readout="target", f_hidden 256, seed-0 weights, chunks of
2048) this script builds the tier three ways on the card: impl="cuda",
impl="torch" twice, and the same propagation in float64
(``chip_smoke.float64_build``: the same float32 weights and edge weights,
widened; ``index_add_`` in float64), and prints,
for each float32 build against each other and against float64: the largest
difference, the share of elements bitwise equal, the largest
|diff| / (atol + rtol |ref|) at ``chip_smoke.py``'s ENGINE_TOL, and the
largest |diff| over the output's largest magnitude. It checks nothing;
exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import ENGINE_TOL as TOL  # noqa: E402
from chip_smoke import PRE_CHUNK as CHUNK  # noqa: E402
from chip_smoke import float64_build  # noqa: E402
from repro_torch.core.program import lower, specialize  # noqa: E402
from repro_torch.gnn.model import GNNConfig, init_gnn  # noqa: E402
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.precompute import propagate  # noqa: E402


def compare(got, want):
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    worst = diff / (TOL["atol"] + TOL["rtol"] * np.abs(want))
    return {"max_abs": float(diff.max()),
            "bitwise": float((got == want).mean()),
            "worst_of_tol": float(worst.max()),
            "share_outside_tol": float((worst > 1).mean()),
            "max_abs_over_max": float(diff.max() / np.abs(want).max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--kinds", default="gcn,sage")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tier_precision_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    graph = get_graph("flickr", scale=1.0)
    out = {}
    for kind in a.kinds.split(","):
        cfg = GNNConfig(kind=kind, n_layers=a.layers, receptive_field=256,
                        f_in=graph.feature_dim, f_hidden=256,
                        readout="target")
        prog, _ = specialize(lower(cfg), n=256, f_in=graph.feature_dim)
        params = init_gnn(cfg, seed=0, device="cuda")
        builds = {name: propagate.layer_major_embeddings(
            graph, prog, params, chunk_size=CHUNK, impl=impl, device="cuda")
            for name, impl in (("cuda", "cuda"), ("torch", "torch"),
                               ("torch2", "torch"))}
        ref = float64_build(graph, prog, params)
        rows = {"max_abs_float64": float(np.abs(ref).max()),
                "cuda_vs_torch": compare(builds["cuda"], builds["torch"]),
                "torch_vs_torch": compare(builds["torch2"],
                                          builds["torch"]),
                "cuda_vs_float64": compare(builds["cuda"], ref),
                "torch_vs_float64": compare(builds["torch"], ref)}
        for k, v in rows.items():
            print(f"[tier precision] {kind} L={a.layers}: {k} {v}",
                  flush=True)
        out[kind] = rows
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
