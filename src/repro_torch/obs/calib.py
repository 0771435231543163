"""Per-op measured latencies: the calibration table for cost dispatch.

The PyTorch package's counterpart of ``repro.obs.calib``. The op-mode mux
(``specialize(mode="auto")``) picks dense vs scatter-gather per op from a
FLOP model; measured-cost dispatch (core.dispatch) drives that decision
from latencies measured on the serving card instead, and this module
records them.

Calibration runs a **separate, sampled pass**: every ``calibrate_every``-th
traced batch, the engine re-executes the program's sections step by step
(the step closures serving uses, via ``program.compile_steps``), waits for
the card after each step (``torch.cuda.synchronize()``, where the
reference blocks on the step's arrays) and records the step's host wall
time into a ``LogHistogram`` keyed ``(op_label, mode, size_bucket)``. A
cell is therefore the eager wall time of one step, launch overhead
included, as in the reference: a step whose kernels are short is priced
at its host cost, which is what serving pays. The pass's outputs are
**discarded**, so enabling calibration never changes serving outputs; it
adds one more execution of the program on the sampled batch, which is why
it defaults to off.

Cell names carry the package's impl: ``cuda/dense``, ``cuda/sg``,
``torch/dense``, ``torch/sg``; the tuned kernels' cells are
``fused_gnn`` / ``cuda/bf=<B>`` and ``scatter_gather`` / ``cuda/bc=<B>``.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.obs.hist import LogHistogram
from repro_torch.obs.trace import now

CALIB_SCHEMA = 1


class CalibrationArtifactError(RuntimeError):
    """Persisted calibration does not match the live deployment."""


def op_label(ops: Tuple) -> str:
    """Step label: the op class name, or the fused group joined with
    '+' (e.g. ``Aggregate+Residual+Transform`` for the kernel peephole)."""
    return "+".join(type(o).__name__ for o in ops)


def op_mode(ops: Tuple, impl: str) -> str:
    """``impl/opmode`` — e.g. ``cuda/dense``, ``torch/sg``; ops without
    a dense/sg mux (Residual, AttentionScore) report ``impl/-``."""
    for o in ops:
        m = getattr(o, "mode", None)
        if m:
            return f"{impl}/{m}"
    return f"{impl}/-"


def size_bucket(batch: Dict) -> int:
    """Power-of-two work bucket: bit length of total vertex slots C*N
    (the quantity every ACK kernel's cost scales with). Same deployment
    -> same bucket, so per-deployment tables stay single-bucket while a
    table aggregated across deployments keeps sizes apart."""
    mask = batch.get("mask")
    if mask is None:
        return 0
    c, n = mask.shape[0], mask.shape[1]
    return int(c * n).bit_length()


class CalibrationTable:
    """(op_label, mode, size_bucket) -> LogHistogram of step seconds."""

    def __init__(self):
        self._hists: Dict[Tuple[str, str, int], LogHistogram] = {}
        self._lock = threading.Lock()
        self.passes = 0
        # bumped on every record — dispatch policies key their cached
        # per-bucket decisions on it, so a table that stops growing
        # (warmup over) costs one dict probe per batch, not a re-solve
        self.version = 0

    def record(self, label: str, mode: str, bucket: int,
               dur_s: float) -> None:
        key = (label, mode, bucket)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = LogHistogram()
            self.version += 1
        h.record(dur_s)

    def rows(self) -> List[dict]:
        """Flat sorted rows — what ``trace_report()['calibration']``
        exposes and what a measured-cost dispatcher would consume."""
        with self._lock:
            items = sorted(self._hists.items())
        out = []
        for (label, mode, bucket), h in items:
            out.append({"op": label, "mode": mode, "size_bucket": bucket,
                        "count": h.count, "mean_s": round(h.mean, 9),
                        "p50_s": round(h.quantile(0.5), 9),
                        "p99_s": round(h.quantile(0.99), 9)})
        return out

    def lookup(self, op: str, impl_mode: str,
               size: int = None) -> float:
        """Measured p50 step seconds for ``(op, impl_mode)`` — e.g.
        ``("Aggregate", "torch/sg")`` — at ``size`` (a ``size_bucket``
        value), or at the most-sampled bucket when ``size`` is None.
        Returns None when the cell has no samples, so a dispatcher can
        fall back to the static FLOP model per-cell."""
        with self._lock:
            if size is not None:
                h = self._hists.get((op, impl_mode, size))
            else:
                cands = [h for (lbl, m, _), h in self._hists.items()
                         if lbl == op and m == impl_mode]
                h = max(cands, key=lambda h: h.count, default=None)
        if h is None or not h.count:
            return None
        return h.quantile(0.5)

    def to_dict(self) -> dict:
        return {"passes": self.passes, "rows": self.rows()}

    def to_cells(self) -> dict:
        """Lossless serialization: every cell's full sparse histogram
        (``rows()`` keeps only the summary stats) — what persistence
        saves so a restarted server dispatches from the same p50s."""
        with self._lock:
            items = sorted(self._hists.items())
        return {"passes": self.passes,
                "cells": [{"op": label, "mode": mode, "bucket": bucket,
                           "hist": h.to_dict()}
                          for (label, mode, bucket), h in items]}

    @classmethod
    def from_cells(cls, d: dict) -> "CalibrationTable":
        """Inverse of ``to_cells``."""
        t = cls()
        t.passes = int(d.get("passes", 0))
        for cell in d.get("cells", ()):
            key = (str(cell["op"]), str(cell["mode"]),
                   int(cell["bucket"]))
            t._hists[key] = LogHistogram.from_dict(cell["hist"])
            t.version += 1
        return t

    def __len__(self) -> int:
        with self._lock:
            return len(self._hists)


def _sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_instrumented(program, params, batch, impl: str,
                     table: CalibrationTable) -> None:
    """One instrumented pass over the program's sections.

    Uses the step closures serving uses (``compile_steps``), waiting for
    the card after each step so that the recorded host wall time covers
    that step's device work. Inner layers run one per index ``i`` of the
    stacked weights, as serving runs them. All outputs are discarded."""
    from repro_torch.core.program import compile_steps

    bucket = size_bucket(batch)
    dev = batch["feats"].device

    def timed_section(section_params, h, steps, h0=None):
        regs = {"h": h, "h_in": h, "h0": h if h0 is None else h0}
        for ops, step in steps:
            _sync(dev)
            t0 = now()
            step(section_params, regs, batch)
            _sync(dev)
            table.record(op_label(ops), op_mode(ops, impl), bucket,
                         now() - t0)
        return regs["h"]

    with torch.inference_mode():
        steps0 = compile_steps(program.layer0, impl)
        h = timed_section(params["layer0"], batch["feats"], steps0)
        if program.n_layers > 1:
            steps_i = compile_steps(program.inner, impl)
            h0 = h
            for i in range(program.n_layers - 1):
                lp = {k: v[i] for k, v in params["layers"].items()}
                h = timed_section(lp, h, steps_i, h0=h0)
    # the tail (Readout/Classify) is a mask-reduce + one matmul — noise
    # next to the layer ops, and it has no dense/sg mux to calibrate
    table.passes += 1


# ---------------------------------------------------------------------------
# warmup / exploration policy


class WarmupSchedule:
    """Deterministic seeded exploration schedule for cold table cells.

    Per size-bucket, the first ``2 * passes`` dispatch decisions each
    trigger one instrumented eager pass through a FORCED mode vector
    (all-mux-dense / all-mux-sg, alternating; the seed picks which side
    goes first per bucket). The forced pass's outputs are discarded —
    serving itself stays on the fallback decision during warmup, so a
    dispatch-enabled run remains bitwise-identical to its forced-mode
    twin while both mode columns of the table fill in."""

    def __init__(self, passes: int = 4, seed: int = 0):
        self.passes = int(passes)
        self.seed = int(seed)
        self._done: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.history: List[Tuple[int, str]] = []   # (bucket, mode) order

    def _first(self, bucket: int) -> Tuple[str, str]:
        r = np.random.default_rng((self.seed, bucket)).integers(2)
        return ("dense", "sg") if r == 0 else ("sg", "dense")

    def next_mode(self, bucket: int) -> Optional[str]:
        """Consume one warmup slot for ``bucket``; None once exhausted."""
        with self._lock:
            k = self._done.get(bucket, 0)
            if k >= 2 * self.passes:
                return None
            self._done[bucket] = k + 1
            mode = self._first(bucket)[k % 2]
            self.history.append((bucket, mode))
            return mode

    def active(self, bucket: int) -> bool:
        with self._lock:
            return self._done.get(bucket, 0) < 2 * self.passes

    def state(self) -> dict:
        with self._lock:
            return {"passes": self.passes, "seed": self.seed,
                    "done": {int(b): int(k)
                             for b, k in sorted(self._done.items())}}


# ---------------------------------------------------------------------------
# kernel block-size autotune (rides the same table)

# cell naming for tuned kernels: op="fused_gnn" mode="cuda/bf=<B>",
# op="scatter_gather" mode="cuda/bc=<B>" — same (op, mode, bucket) key
# space as the per-op cells, so persistence and reports carry both


# clock cycles the card spins before each timed launch of a block
# candidate (~1 ms on an H100): the launch and its events are queued behind
# the spin, so host time between them (the wrapper, another thread holding
# the GIL) is not in the reading
_SPIN_CYCLES = 2_000_000


def _time_call(fn, device, rounds: int = 5) -> float:
    """Seconds a call of ``fn`` takes, after one warm (untimed) call. On the
    card: the least over ``rounds`` launches, each between two CUDA events
    queued behind a ~1 ms spin of the card, so the reading is the kernel's
    own time. The candidates of one knob differ only on the card, and one
    call's host wall (serving threads share the host) would let the host's
    noise choose. On the CPU: the host seconds of one call."""
    fn()
    if device.type != "cuda":
        t0 = now()
        fn()
        return now() - t0
    best = float("inf")
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def run_block_autotune(program, params, batch, table: CalibrationTable,
                       ) -> None:
    """Time the fused-layer and scatter-gather kernels over the block
    knobs they really have, on THIS batch's tensors, and record the times
    as table cells. Only knobs that leave the result bitwise unchanged are
    swept, so a tuned variant serves the same bits as the default:

    - the sort scatter-gather's columns a block (``BLOCK_COLS_CANDIDATES``,
      each that fits its shared memory at (N, E));
    - the fused layer's ``block_f`` (``BLOCK_F_CANDIDATES`` dividing Fout),
      which groups column tiles of the ``cuda_core`` kernel. The serving
      kernel, ``tf32x3``, takes no block: at its shapes the fused cells are
      not swept, ``best_block`` finds no grid and the default stays, as in
      the reference where a grid is incomplete. (On the CPU the wrappers
      run their plain versions, which take the knobs and ignore them.)

    Where the reference reads the host clock around one blocked call, the
    port times each candidate between CUDA events (``_time_call``). The
    sort kernel's default width already follows F
    (``scatter_gather.sort_block_cols``): the sweep, at the batch's input
    width, confirms it or finds a faster one for the sg Aggregates.

    Outputs are discarded — like ``run_instrumented``, tuning never
    changes serving results."""
    from repro_torch.core.program import Transform
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_gnn import (BLOCK_F_CANDIDATES,
                                               fused_variant)
    from repro_torch.kernels.scatter_gather import (BLOCK_COLS_CANDIDATES,
                                                    sort_block_fits)

    bucket = size_bucket(batch)
    h = batch["feats"]
    dev = h.device
    adj = batch.get("adj", batch.get("adj_mean"))
    w = None
    for op in program.layer0:        # representative Fout: first FT weight
        if isinstance(op, Transform):
            w = params["layer0"][op.w]
            break
    with torch.inference_mode():
        if adj is not None and w is not None:
            _, n, fin = h.shape
            fout = int(w.shape[1])
            bf16 = h.dtype == torch.bfloat16
            aligned = all(t.data_ptr() % 16 == 0
                          for t in (h, adj, *((w,) if bf16 else ())))
            # the tensor-core kernels take one column tile a block: block_f
            # changes nothing there
            no_block = dev.type == "cuda" and fused_variant(
                n, fin, True, aligned, bf16, fout) \
                != "cuda_core"
            for bf in () if no_block else BLOCK_F_CANDIDATES:
                if bf > fout or fout % bf:
                    continue
                args = (adj, h, w, None, None, batch.get("mask"))
                table.record("fused_gnn", f"cuda/bf={bf}", bucket,
                             _time_call(lambda: kops.fused_gnn_layer(
                                 *args, block_f=bf), dev))
        if "edge_src" in batch:
            args = (batch["edge_src"], batch["edge_dst"], batch["edge_w"],
                    h)
            n, e = h.shape[1], args[0].shape[1]
            for bc in BLOCK_COLS_CANDIDATES:
                if not sort_block_fits(n, e, bc):
                    continue
                table.record("scatter_gather", f"cuda/bc={bc}", bucket,
                             _time_call(lambda: kops.scatter_gather_aggregate(
                                 *args, block_cols=bc), dev))


def best_block(table: CalibrationTable, kernel: str, prefix: str,
               candidates, bucket: int) -> Optional[int]:
    """Lowest-p50 candidate for one tuned kernel at ``bucket``, or None
    until EVERY candidate cell is populated (a partially explored grid
    must not override the default — the unexplored candidate might win).
    Candidates with no cell at all (e.g. a bf that does not divide this
    deployment's Fout, skipped by the tuner) are excluded from the
    completeness requirement when no candidate has a cell yet."""
    seen = []
    for c in candidates:
        v = table.lookup(kernel, f"cuda/{prefix}{c}", bucket)
        seen.append((c, v))
    with_cells = [(c, v) for c, v in seen if v is not None]
    if not with_cells:
        return None
    # the tuner records every legal candidate in one pass, so "some but
    # not all legal candidates" only happens mid-pass — wait it out
    legal = {c for c, _ in with_cells}
    if any(v is None for c, v in seen if c in legal):
        return None
    return min(with_cells, key=lambda cv: cv[1])[0]


# ---------------------------------------------------------------------------
# persistence (repro_torch.ckpt) — a restarted server dispatches warm


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def graph_structure_fingerprint(graph) -> str:
    """CSR structure only — features don't move op latencies, so a
    feature refresh keeps the table warm while an edge-structure change
    (different densities) invalidates it."""
    return _sha(graph.indptr, graph.indices)


def calibration_signature(cfg, impl: str) -> dict:
    """Everything the measured step latencies are a function of besides
    the graph: the model shape (op stream + feature widths + receptive
    field, which also fixes the size bucket) and the kernel substrate."""
    return {"kind": cfg.kind, "n_layers": cfg.n_layers,
            "f_in": cfg.f_in, "f_hidden": cfg.f_hidden,
            "receptive_field": cfg.receptive_field, "impl": impl}


def save_calibration(path: str, table: CalibrationTable, *, graph, cfg,
                     impl: str) -> str:
    """Persist the table (all cells, incl. block-size cells) as one
    committed ``repro_torch.ckpt`` step stamped with the deployment
    fingerprints; returns the artifact directory."""
    from repro_torch.ckpt import checkpoint as ckpt
    extra = {"schema": CALIB_SCHEMA,
             "graph_fingerprint": graph_structure_fingerprint(graph),
             "model": calibration_signature(cfg, impl),
             "table": table.to_cells()}
    # the ckpt layout wants an array tree; the table itself is manifest
    # metadata (pure JSON), so the tree is a one-cell sentinel
    ckpt.save(path, 0, {"calib_cells": np.array([len(table)], np.int64)},
              extra=extra)
    return path


def load_calibration(path: str, *, graph, cfg,
                     impl: str) -> CalibrationTable:
    """Load + validate a persisted table against the live deployment.
    Raises ``CalibrationArtifactError`` naming the first mismatched
    stamp — stale measured latencies must never drive dispatch."""
    from repro_torch.ckpt import checkpoint as ckpt
    _, _, extra = ckpt.restore(
        path, {"calib_cells": np.zeros(1, np.int64)})
    remedy = (f"delete {path!r} and let the engine re-explore (the "
              f"dispatch warmup policy rebuilds the table on the next "
              f"run), or point DispatchConfig(artifact=...) at the "
              f"matching deployment's artifact")
    checks = [
        ("schema", CALIB_SCHEMA,
         "the calibration artifact schema has changed"),
        ("graph_fingerprint", graph_structure_fingerprint(graph),
         "the graph's CSR structure has changed since the table was "
         "measured — its densities (and so the measured mode costs) no "
         "longer describe this deployment"),
        ("model", calibration_signature(cfg, impl),
         "the model configuration or kernel substrate differs from the "
         "one the table was measured on"),
    ]
    for key, live, why in checks:
        if extra.get(key) != live:
            raise CalibrationArtifactError(
                f"stale calibration artifact at {path!r}: {key} "
                f"mismatch (artifact {extra.get(key)!r} vs live "
                f"{live!r}). {why}; {remedy}.")
    return CalibrationTable.from_cells(extra["table"])


__all__ = ["CalibrationTable", "CalibrationArtifactError",
           "WarmupSchedule", "run_instrumented", "run_block_autotune",
           "best_block", "save_calibration", "load_calibration",
           "calibration_signature", "graph_structure_fingerprint",
           "op_label", "op_mode", "size_bucket"]
