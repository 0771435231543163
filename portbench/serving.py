"""The system under test: the port's ``GNNServer`` over one
``DecoupledEngine``, built from a configuration file, the benchmark's graph
and weights the benchmark draws on the device. Also the counters the
per-layer metrics read, and the host spans a traced run records around
the program's stages."""
from __future__ import annotations

import dataclasses
import importlib
import math
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch


def make_params(cfg: dict, seed: int, device) -> dict:
    """The model's weights, drawn on ``device`` from the seed in one call
    a parameter: the port's tree (``layer0``, then the L-1 inner layers
    stacked), named and shaped by the configuration's reference module.
    Weights are fan-in normal times ``weights.gain``; biases normal with
    ``weights.bias_std``."""
    shapes = importlib.import_module(
        f"portbench.reference.{cfg['reference']}").param_shapes
    gen = torch.Generator(device=device).manual_seed(int(seed))
    gain, bias_std = cfg["weights"]["gain"], cfg["weights"]["bias_std"]

    def draw(shape, fan_in):
        x = torch.randn(shape, generator=gen, device=device)
        return x * (bias_std if fan_in == 0 else gain / math.sqrt(fan_in))

    f, layers = cfg["f_hidden"], cfg["n_layers"]
    params = {"layer0": {k: draw(s, fi) for k, (s, fi)
                         in shapes(cfg, cfg["f_in"], f).items()}}
    if layers > 1:
        params["layers"] = {k: draw((layers - 1, *s), fi) for k, (s, fi)
                            in shapes(cfg, f, f).items()}
    return params


def _then_set(fn, event: threading.Event):
    def done(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        finally:
            event.set()
    return done


def _fields(cls, cfg: dict) -> dict:
    """The configuration's keys that name a field of the port's dataclass
    ``cls``, but its ``name``, which is the configuration's."""
    names = {f.name for f in dataclasses.fields(cls)} - {"name"}
    return {k: v for k, v in cfg.items() if k in names}


class System:
    """One deployment of the port, started, with its caches to be filled
    by ``fill``. Every key of the configuration that names a field of the
    port's ``GNNConfig`` or ``ServingConfig`` is passed to it (``store`` as
    a ``StorePolicy``); the device and the kernels' ``impl`` are the
    run's."""

    def __init__(self, graph, cfg: dict, params: dict, device: str,
                 impl: str):
        from repro_torch.core.config import ServingConfig
        from repro_torch.core.engine import DecoupledEngine
        from repro_torch.gnn.model import GNNConfig
        from repro_torch.graphs.csr import CSRGraph
        from repro_torch.serve.gnn_server import GNNServer
        from repro_torch.store.policy import StorePolicy
        self.cfg = cfg
        g = CSRGraph(indptr=graph.indptr, indices=graph.indices,
                     features=graph.features, name=cfg["name"])
        model = GNNConfig(**_fields(GNNConfig, cfg))
        serving = ServingConfig(**dict(
            _fields(ServingConfig, cfg), device=device, impl=impl,
            store=StorePolicy(**cfg["store"])))
        self.engine = DecoupledEngine(g, model, params=params,
                                      config=serving)
        self.server = GNNServer(self.engine, config=serving)
        self.server.start()
        self.submit = self.server.submit
        self.spans: List[Tuple[str, int, int]] = []
        # set each time a batch's answers come, so the load generator
        # waits on it instead of polling
        self.answered = threading.Event()
        for lane in self.server._lanes.values():
            lane._on_done = _then_set(lane._on_done, self.answered)

    def fill(self, targets: np.ndarray, timeout: float = 1200.0) -> None:
        """Serve each target once: the caches then hold these targets, and
        every shape the window uses has run."""
        reqs = [self.submit(int(t)) for t in targets]
        self.server.drain(reqs, timeout=timeout)

    def counters(self) -> Dict[str, object]:
        """The program's own counters, read between batches."""
        from repro_torch.kernels import fused_gnn, gat_attention
        st = self.engine.scheduler.stats
        lane = self.server.stats
        return {"fused_forms": dict(fused_gnn.form_launches),
                "gat_launches": gat_attention.launches,
                "batches": st.n_batches, "packs": st.n_density,
                "stage_s": dict(st.stage_times),
                "bytes_shipped": st.bytes_shipped,
                "build_hits": st.build_hits,
                "build_misses": st.build_misses,
                "served": lane.hist.count,
                "lane_batches": lane.n_batches}

    def record_spans(self) -> None:
        """Record a host span (label, start, end in perf_counter ns) around
        each stage's run, each batch's device launch and each batch's
        completion callback, by wrapping the bound methods on these
        instances (the program's files are unchanged)."""
        spans = self.spans

        def wrap(label, fn):
            def timed(*args, **kwargs):
                t = time.perf_counter_ns()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spans.append((label, t, time.perf_counter_ns()))
            return timed

        for st in self.engine.stages:
            st.run = wrap(st.name, st.run)
        sched = self.engine.scheduler
        sched.device_fn = wrap("launch", sched.device_fn)
        for lane in self.server._lanes.values():
            lane._on_done = wrap("complete", lane._on_done)

    def close(self) -> None:
        self.server.stop()
        self.engine.close()

