"""Metrics smoke of the PyTorch package: serve, scrape the live endpoint,
validate.

Boots a ``repro_torch`` GNNServer with telemetry on (ephemeral exposition
port) over an ``inproc`` graph host (full wire codec, one process, so the
cluster scrape path and the graph host's registry both light up), drives
enough traffic to populate every instrumented site, then scrapes the real
HTTP endpoint the way Prometheus would and runs the package's exposition
validator over the body. Fails (exit 1 via an exception) if the endpoint
is down, the text is malformed, or fewer than ``MIN_SERIES`` series show
up. The counterpart of scripts/metrics_smoke.py; it imports nothing of
JAX or of the reference package.

    python scripts/torch_metrics_smoke.py                       # on a card
    python scripts/torch_metrics_smoke.py --device cpu --impl torch
"""
from __future__ import annotations

import argparse
import os
import sys
import urllib.request

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

MIN_SERIES = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the program (default: cuda; "
                         "raises without a card)")
    ap.add_argument("--impl", default="cuda", choices=("cuda", "torch"),
                    help="kernel substrate (default: the CUDA kernels)")
    args = ap.parse_args(argv)

    from repro_torch.core.config import ServingConfig
    from repro_torch.gnn.model import GNNConfig, init_gnn
    from repro_torch.graphs.synthetic import get_graph, zipf_traffic
    from repro_torch.obs import TelemetryConfig, validate_exposition
    from repro_torch.obs.metrics import series_count
    from repro_torch.serve.gnn_server import GNNServer

    g = get_graph("flickr", scale=0.004, seed=0)
    cfg = GNNConfig(kind="gcn", n_layers=2, receptive_field=16,
                    f_in=g.feature_dim)
    params = init_gnn(cfg, 0, device=args.device)
    sc = ServingConfig(device=args.device, impl=args.impl, batch_size=8,
                       num_threads=2, transport="inproc",
                       telemetry=TelemetryConfig(port=0, window_s=5.0))
    server = GNNServer(config=sc)
    server.register("gcn", graph=g, cfg=cfg, params=params)
    server.start()
    try:
        reqs = [server.submit(int(t), model="gcn")
                for t in zipf_traffic(g, 128, 1.1, 1)]
        server.drain(reqs, timeout=300.0)

        url = server.metrics_url
        if not url:
            raise RuntimeError("telemetry port configured but no endpoint "
                               "mounted")
        with urllib.request.urlopen(url, timeout=10) as resp:
            if resp.status != 200:
                raise RuntimeError(f"GET {url} -> {resp.status}")
            ctype = resp.headers.get("Content-Type", "")
            body = resp.read().decode("utf-8")
        if "version=0.0.4" not in ctype:
            raise RuntimeError(f"content-type: {ctype!r}")
        problems = validate_exposition(body)
        if problems:
            raise RuntimeError(f"exposition invalid: {problems[:5]}")
        n = series_count(server.metrics_wire())
        families = sorted({ln.split()[2] for ln in body.splitlines()
                           if ln.startswith("# TYPE ")})
        print(f"scraped {url}: {n} series across {len(families)} "
              f"families, exposition valid (device {args.device}, impl "
              f"{args.impl})")
        for fam in families:
            print(f"  {fam}")
        if n < MIN_SERIES:
            raise RuntimeError(f"only {n} series exposed (floor "
                               f"{MIN_SERIES})")
    finally:
        server.stop()
        for name in server.models:
            server.engine_for(name).close()
    print("metrics smoke: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
