"""Layer-major offline propagation: full-graph embeddings, one layer at a
time (the DGL ``inference()`` pattern), in PyTorch.

The PyTorch counterpart of ``repro.precompute.propagate``. The online path
evaluates the whole L-layer program on each target's induced subgraph.
Offline, layer ``l``'s output is computed for EVERY vertex before layer
``l+1`` starts, so working memory is one [V, f] register per live value plus
a one-hop x ``chunk_size`` aggregation working set, never L hops of
neighborhood fan-out. The op streams executed are the same lowered
``AckProgram`` sections the online engine runs (Aggregate, Transform,
Residual against the ``h0`` teleport anchor), so a precomputed row matches
what the online path produces for a full-coverage subgraph.

Aggregate runs chunk by chunk on the scatter-gather kernel
(``kernels.scatter_gather.scatter_gather_aggregate``, C=1) under
``impl="cuda"`` and on its plain version under ``impl="torch"``. A chunk
gathers from the full [V, f] register into ``chunk_size`` destination
rows; so each chunk is given in compact form: its distinct source rows
(``index_select`` from the register), its edges' sources renumbered into
them, and N = max(chunk, sources) rows, and the kernel writes only the
first ``chunk`` rows (``n_out``), the chunk's destinations, as the
reference's ``segment_sum(num_segments=chunk)`` does. The renumbering,
computed once per compute set, changes no sum: the kernel adds each
destination's edges in edge order.
Transform is ``torch.matmul`` (the reference's ``_ft`` is a jnp product
outside any Pallas kernel), in fp32 as the process's TF32 setting leaves it
(off by default).

``out_ids`` turns the same code path into the refresh primitive: the
dependency closure (one inbound hop per executed Aggregate) is computed,
propagation runs on the induced sub-CSR with GLOBAL degree normalization,
and only the requested rows come back.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.program import (ACTS, IMPLS, AckProgram, Aggregate,
                                      Classify, Readout, Residual,
                                      Transform)
from repro_torch.devices import resolve
from repro_torch.gnn.model import params_to
from repro_torch.graphs.csr import _gather_ranges, subgraph_edges
from repro_torch.kernels import scatter_gather as sg


class PrecomputeError(ValueError):
    """The lowered program cannot be served from the offline tier."""


def check_precomputable(prog: AckProgram) -> None:
    """Raise PrecomputeError unless every executed layer op is pure
    propagation (Aggregate/Residual/Transform) and the readout is the
    target row: the regime where one stored row per vertex IS the online
    answer."""
    for site, op in prog.ops:
        if site.startswith("tail"):
            if isinstance(op, Readout) and op.kind != "target":
                raise PrecomputeError(
                    f"{prog.kind!r} is not precomputable: Readout"
                    f"[{op.kind}] reduces over the induced SUBGRAPH, so "
                    "the answer is not one row per vertex. Only "
                    "readout='target' models can serve from the offline "
                    "tier; route this model through the online path "
                    "(drop it from PrecomputeConfig.models).")
        elif not isinstance(op, (Aggregate, Residual, Transform)):
            raise PrecomputeError(
                f"{prog.kind!r} is not precomputable: {site} executes "
                f"{op.describe()}, but offline layer-major propagation "
                "supports pure Aggregate/Residual/Transform layers "
                "(attention softmax support depends on the induced "
                "subgraph). Route this model through the online path "
                "(drop it from PrecomputeConfig.models).")


def agg_hops(prog: AckProgram) -> int:
    """Graph hops one output row depends on = executed Aggregate count
    (the inner section runs n_layers - 1 times)."""
    hops = sum(isinstance(op, Aggregate) for op in prog.layer0)
    if prog.n_layers > 1:
        hops += (prog.n_layers - 1) * sum(isinstance(op, Aggregate)
                                          for op in prog.inner)
    return hops


def dependency_closure(graph, out_ids: np.ndarray,
                       hops: int) -> np.ndarray:
    """Sorted unique vertex set whose layer-0 inputs determine the final
    embeddings of ``out_ids``: out_ids plus ``hops`` inbound neighbor
    expansions (the graph is symmetrized, so out-edges are in-edges)."""
    indptr, indices = graph.indptr, graph.indices
    ball = np.unique(np.asarray(out_ids, np.int64))
    cur = ball
    for _ in range(hops):
        if not len(cur):
            break
        starts, ends = indptr[cur], indptr[cur + 1]
        total = int((ends - starts).sum())
        if not total:
            break
        if len(cur) < 4096:
            nbrs = np.concatenate([indices[s:e]
                                   for s, e in zip(starts, ends)])
        else:
            nbrs = _gather_ranges(indices, starts, ends, total)
        new = np.setdiff1d(np.unique(nbrs).astype(np.int64), ball,
                           assume_unique=True)
        if not len(new):
            break
        ball = np.union1d(ball, new)
        cur = new
    return ball


def chunk_aggregate(src, dst, w, h, impl: str = "cuda",
                    n_out: Optional[int] = None) -> torch.Tensor:
    """One chunk's Aggregate in compact form: ``src``/``dst`` [1, E] int32
    (sources index ``h``'s rows, destinations the chunk's), ``w`` [1, E]
    float32 (the padding edges carry 0), ``h`` [1, N, F]. Returns
    [1, n_out, F] (``n_out`` None: N), the chunk's rows first. Under
    impl="cuda" this is the scatter-gather kernel (its plain version for
    CPU tensors), under impl="torch" the plain version."""
    if impl == "cuda":
        return sg.scatter_gather_aggregate(src, dst, w, h, n_out=n_out)
    return sg.scatter_gather_aggregate_ref(src, dst, w, h, n_out)


def compact_chunk(src: np.ndarray, rel: np.ndarray, e_cap: int,
                  chunk: int) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, int]:
    """A chunk's edge list in the kernel's compact form.

    ``src`` [e] holds compute-set row ids, ``rel`` [e] the destinations'
    offsets in the chunk. Returns (rows [S]: the distinct source rows to
    gather, in increasing order; src [e_cap] int32 renumbered into them;
    dst [e_cap] int32; N = max(chunk, S)). Padding edges (e_cap - e of them,
    weight 0 in every norm) point from compute-set row 0 to destination 0,
    as the reference's chunk function pads, so row 0 joins the sources
    where there is padding: a non-finite row 0 poisons destination 0 in
    both."""
    e = len(src)
    pad = e < e_cap
    rows, inv = np.unique(np.concatenate([src, [0]]) if pad else src,
                          return_inverse=True)
    out_src = np.zeros(e_cap, np.int32)
    out_dst = np.zeros(e_cap, np.int32)
    out_src[:e] = inv[:e]
    if pad:
        out_src[e:] = inv[e]             # row 0's position (0: rows sorted)
    out_dst[:e] = rel
    return rows.astype(np.int64), out_src, out_dst, max(chunk, len(rows))


class _LocalCSR:
    """The induced sub-CSR over the compute set, with edge weights under
    GLOBAL-graph normalization (what a full-coverage online subgraph
    computes: induced degree == global degree) and per-chunk edge slices
    padded to one uniform cap (a multiple of 128). Each chunk's compact
    form (``compact_chunk``) lives on ``device`` from construction on, its
    weights per norm from first use."""

    def __init__(self, snap, ids: np.ndarray, chunk_size: int,
                 impl: str, device: torch.device):
        self.ids = ids
        self.n = n = len(ids)
        self.chunk = min(chunk_size, n)
        self.impl, self.device = impl, device
        deg = np.diff(snap.indptr)[ids].astype(np.float64)
        src, dst = subgraph_edges(snap, ids)
        order = np.argsort(dst, kind="stable")   # group edges by dst chunk
        self.src = src[order].astype(np.int32)
        dst = dst[order].astype(np.int64)
        self.dst = dst
        # chunk boundaries over local dst ids
        self.starts = list(range(0, n, self.chunk))
        self.e_ranges = [(int(np.searchsorted(dst, c0)),
                          int(np.searchsorted(dst, c0 + self.chunk)))
                         for c0 in self.starts]
        cap = max((e1 - e0 for e0, e1 in self.e_ranges), default=0)
        self.e_cap = max(1, cap + (-cap) % 128)
        # global-degree normalization (float64 math, cast to float32: the
        # dtypes the online Build stage uses)
        d_hat = deg + 1.0                        # self loop counts as 1
        inv_sqrt = 1.0 / np.sqrt(d_hat)
        ds, dd = self.src.astype(np.int64), dst
        self._w = {
            "gcn": (inv_sqrt[dd] * inv_sqrt[ds]).astype(np.float32),
            "mean": (1.0 / np.maximum(deg, 1.0))[dd].astype(np.float32),
            "binary": np.ones(len(ds), np.float32),
        }
        self.self_w = torch.from_numpy(
            (inv_sqrt * inv_sqrt).astype(np.float32)).to(device)
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        self._chunks: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 int]] = []
        for c0, (e0, e1) in zip(self.starts, self.e_ranges):
            rows, csrc, cdst, nrows = compact_chunk(
                self.src[e0:e1], (self.dst[e0:e1] - c0).astype(np.int32),
                self.e_cap, self.chunk)
            self._chunks.append((t(rows), t(csrc)[None], t(cdst)[None],
                                 nrows))
        self._w_dev: Dict[str, List[torch.Tensor]] = {}

    @property
    def num_chunks(self) -> int:
        return len(self.starts)

    def _weights(self, norm: str) -> List[torch.Tensor]:
        """Each chunk's [1, e_cap] float32 edge weights under ``norm``
        (padding 0), uploaded once."""
        if norm not in self._w_dev:
            w_all = self._w[norm]
            out = []
            for e0, e1 in self.e_ranges:
                w = np.zeros(self.e_cap, np.float32)
                w[:e1 - e0] = w_all[e0:e1]
                out.append(torch.from_numpy(w).to(self.device)[None])
            self._w_dev[norm] = out
        return self._w_dev[norm]

    def aggregate(self, norm: str, H: torch.Tensor) -> torch.Tensor:
        """One Aggregate op over the full register H [n, f], chunked over
        destination vertices; returns the new [n, f] register."""
        out = []
        for c0, (rows, src, dst, nrows), w in zip(
                self.starts, self._chunks, self._weights(norm)):
            h = H.index_select(0, rows)
            if nrows > h.shape[0]:
                h = torch.cat([h, h.new_zeros(nrows - h.shape[0],
                                              h.shape[1])])
            z = chunk_aggregate(src, dst, w, h[None].contiguous(),
                                self.impl, n_out=self.chunk)
            out.append(z[0, :min(self.chunk, self.n - c0)])
        z = torch.cat(out, dim=0) if len(out) > 1 else out[0]
        if norm == "gcn":
            # self-loop term: dense mode bakes it into adj, the edge list
            # excludes it (the online sg kernel's convention)
            z = z + H * self.self_w[:, None]
        return z

    def transform(self, op: Transform, p, H_src, H_in) -> torch.Tensor:
        """One Transform op, chunked over vertices (bounds the working set
        at chunk x max(f_in, f_out))."""
        act = ACTS[op.act]
        out = []
        for c0 in self.starts:
            c1 = min(c0 + self.chunk, self.n)
            if op.w_self:
                b = p[op.b] if op.b else 0.0
                y = (torch.matmul(H_in[c0:c1], p[op.w_self]) + b) \
                    + (torch.matmul(H_src[c0:c1], p[op.w]) + 0.0)
            else:
                y = torch.matmul(H_src[c0:c1], p[op.w])
                if op.b:
                    y = y + p[op.b]
            out.append(act(y))
        return torch.cat(out, dim=0) if len(out) > 1 else out[0]


def _apply_section(local: _LocalCSR, ops, p, H, H0):
    """Run one program section over the full-width registers: the offline
    mirror of program._compile_section (no mask: every row is a real
    vertex)."""
    regs = {"h": H, "h_in": H, "h0": H if H0 is None else H0}
    for op in ops:
        if isinstance(op, Aggregate):
            regs[op.out] = local.aggregate(op.norm, regs[op.src])
        elif isinstance(op, Residual):
            scale = (1.0 + p[op.eps_param]) if op.eps_param else 1.0
            regs[op.into] = scale * regs[op.src] \
                + op.into_gain * regs[op.into]
        elif isinstance(op, Transform):
            regs[op.out] = local.transform(op, p, regs[op.src],
                                           regs["h_in"])
        else:                 # pragma: no cover — check_precomputable
            raise PrecomputeError(f"unsupported op {op!r}")
    return regs["h"]


def _layer(tree, i: int):
    """Layer ``i`` of the stacked inner-layer parameters."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def layer_major_embeddings(graph, prog: AckProgram, params, *,
                           chunk_size: int = 2048,
                           out_ids: Optional[np.ndarray] = None,
                           impl: str = "cuda", device="cuda"
                           ) -> np.ndarray:
    """Offline embeddings for ``out_ids`` (default: every vertex).

    Layer-major schedule: layer0 for all compute-set vertices, then the
    inner section n_layers - 1 times, then the tail, each Aggregate and
    Transform chunked over ``chunk_size`` destination vertices, on
    ``device`` under ``impl`` (the engine's). ``params`` must be the
    UNPADDED model params (the engine's feature padding is an online-batch
    concern); they are moved to ``device``. Returns float32
    [len(out_ids), f_out] on the host.
    """
    check_precomputable(prog)
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}, expected one of {IMPLS}")
    dev = resolve(device)
    # snapshot the CSR arrays: apply_edge_updates swaps whole arrays, so
    # holding these references pins one coherent graph version
    snap = SimpleNamespace(indptr=graph.indptr, indices=graph.indices)
    num_v = len(snap.indptr) - 1
    if out_ids is None:
        ids = np.arange(num_v, dtype=np.int64)
        out_local = slice(None)
    else:
        out_ids = np.asarray(out_ids, np.int64)
        ids = dependency_closure(snap, out_ids, agg_hops(prog))
        out_local = np.searchsorted(ids, out_ids)
    local = _LocalCSR(snap, ids, chunk_size, impl, dev)
    params = params_to(params, dev)
    with torch.inference_mode():
        H = torch.from_numpy(np.ascontiguousarray(
            graph.features[ids], np.float32)).to(dev)
        H = _apply_section(local, prog.layer0, params["layer0"], H, None)
        if prog.n_layers > 1:
            H0 = H            # scan-entry prediction, teleport anchor
            for i in range(prog.n_layers - 1):
                H = _apply_section(local, prog.inner,
                                   _layer(params["layers"], i), H, H0)
        emb = H
        for op in prog.tail:
            if isinstance(op, Readout):
                pass          # kind == "target": the row IS the readout
            elif isinstance(op, Classify):
                emb = emb @ params[op.w] + params[op.b]
            else:             # pragma: no cover — lower() validates tails
                raise PrecomputeError(f"unsupported tail op {op!r}")
        out = emb.float().cpu().numpy()
    return out[out_local]


__all__ = ["PrecomputeError", "check_precomputable", "agg_hops",
           "dependency_closure", "chunk_aggregate", "compact_chunk",
           "layer_major_embeddings"]
