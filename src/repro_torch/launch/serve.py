"""Serving launcher: mini-batch GNN inference (the paper's workload) on
the card, or on the CPU when asked.

  PYTHONPATH=src python -m repro_torch.launch.serve --model gcn \
      --layers 3 --receptive-field 128 --dataset flickr --scale 0.05 \
      --requests 256 --batch-size 64
  ... --device cpu --impl torch          # the plain path on the CPU

Prints the graph, the model's ACK mode, the server's DSE plan for the H100
and the request-latency percentiles. ``--device cuda`` (the default) with
no card raises.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core.config import ServingConfig
from repro_torch.core.engine import DecoupledEngine
from repro_torch.gnn.model import GNNConfig
from repro_torch.graphs.synthetic import get_graph
from repro_torch.serve.gnn_server import GNNServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gcn",
                    choices=["gcn", "sage", "gin", "gat"])
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--receptive-field", type=int, default=128)
    ap.add_argument("--dataset", default="flickr")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    config = ServingConfig(device=args.device, impl=args.impl,
                           batch_size=args.batch_size)
    g = get_graph(args.dataset, scale=args.scale)
    cfg = GNNConfig(kind=args.model, n_layers=args.layers,
                    receptive_field=args.receptive_field,
                    f_in=g.feature_dim)
    engine = DecoupledEngine(g, cfg, config=config)
    print(f"graph {g.name}: {g.num_vertices} vertices, {g.num_edges} edges")
    print(f"model {cfg.display} on {args.device} (impl={args.impl}); ACK "
          f"mode={engine.mode} ({engine.decision.summary}; "
          f"{engine.decision.reason})")

    server = GNNServer(engine)
    plan = server.plan
    print(f"plan (H100): block_f={plan.block_f} c_core={plan.c_core} "
          f"smem_used={plan.smem_used} ops_ok={plan.ops_ok}")
    server.start()
    rng = np.random.default_rng(0)
    reqs = [server.submit(t) for t in
            rng.integers(0, g.num_vertices, size=args.requests)]
    server.drain(reqs, timeout=600)
    server.stop()
    engine.close()
    print(json.dumps(server.stats.percentiles(), indent=1))


if __name__ == "__main__":
    main()
