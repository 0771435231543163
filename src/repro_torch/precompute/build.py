"""Offline artifact build CLI:

  PYTHONPATH=src python -m repro_torch.precompute.build \\
      --dataset flickr --scale 0.01 --kind sgc --out /tmp/sgc_tier

Builds the full-graph layer-major embedding table for one (dataset, model)
deployment and persists it through ``ckpt.checkpoint``, stamped with the
graph/model/params fingerprints ``load_artifact`` validates against. An
engine loads it with ``PrecomputeConfig(artifact=<out>)``; the deployment
must use the SAME graph (dataset/scale/seed) and the same model seed, or
loading fails with the mismatch error. The build runs under ``--impl``
(``cuda``: every Aggregate on the scatter-gather kernel; ``torch``: its
plain version) on ``--device`` (``cuda`` by default: without a card it
raises; pass ``--device cpu`` to build on the CPU).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.program import IMPLS, lower, specialize
from repro_torch.gnn.model import GNNConfig, init_gnn
from repro_torch.graphs.synthetic import get_graph
from repro_torch.precompute.artifact import save_artifact
from repro_torch.precompute.propagate import layer_major_embeddings


def build(graph, cfg: GNNConfig, params, out: str,
          chunk_size: int = 2048, impl: str = "cuda",
          device="cuda") -> dict:
    """Programmatic entry: build + persist, returns a summary dict."""
    prog, _ = specialize(lower(cfg), n=cfg.receptive_field,
                         f_in=cfg.f_in, f_hidden=cfg.f_hidden)
    t0 = time.perf_counter()
    emb = layer_major_embeddings(graph, prog, params,
                                 chunk_size=chunk_size, impl=impl,
                                 device=device)
    seconds = time.perf_counter() - t0
    save_artifact(out, emb, graph, cfg, params)
    return {"out": out, "num_vertices": int(emb.shape[0]),
            "f_out": int(emb.shape[1]),
            "bytes": int(emb.nbytes), "kind": cfg.kind,
            "n_layers": cfg.n_layers, "impl": impl, "device": str(device),
            "build_s": round(seconds, 6)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="build the offline precompute embedding artifact")
    ap.add_argument("--dataset", default="flickr",
                    help="synthetic dataset name (flickr/reddit/...)")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--graph-seed", type=int, default=0)
    ap.add_argument("--kind", default="sgc",
                    help="model kind (must lower to a precomputable "
                         "program, e.g. sgc/appnp/gcn)")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--classes", type=int, default=0)
    ap.add_argument("--rf", type=int, default=128,
                    help="receptive field of the serving deployment")
    ap.add_argument("--seed", type=int, default=0,
                    help="model param seed — must match the serving "
                         "ServingConfig(seed=...)")
    ap.add_argument("--chunk-size", type=int, default=2048)
    ap.add_argument("--impl", choices=IMPLS, default="cuda",
                    help="cuda: Aggregates on the scatter-gather kernel; "
                         "torch: its plain version")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    g = get_graph(a.dataset, scale=a.scale, seed=a.graph_seed)
    cfg = GNNConfig(kind=a.kind, n_layers=a.layers,
                    receptive_field=a.rf, f_in=g.feature_dim,
                    f_hidden=a.hidden, num_classes=a.classes,
                    readout="target")
    params = init_gnn(cfg, a.seed, device=a.device)
    info = build(g, cfg, params, a.out, chunk_size=a.chunk_size,
                 impl=a.impl, device=a.device)
    info["avg_degree"] = round(float(np.mean(g.degrees)), 2)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
