"""Design Space Exploration (paper §4.5) for an NVIDIA H100.

The paper's DSE picks, from a DSP budget, (1) N_ALU per ALU, (2) the ACK
array size p_sys, (3) the PE count N_pe: one bitstream for a SET of GNN
models. ``repro.core.dse`` maps that onto a TPU's VMEM and MXU; this is
its counterpart for the card this package's kernels run on. One plan
serves every model in the set:

  Step 1 (N_ALU): every op of every model's lowered program must map to a
          primitive the card's CUDA and tensor cores run (``H100_OPS``).
  Step 2 (p_sys): the fused layer's output-feature block. On the card it
          is fixed by the kernel, not searched: the ``tf32x3`` kernel
          takes 64 output columns a block with a fixed 197,712-byte
          shared-memory layout for N <= 256 (csrc/fused_gnn.cu). What a
          model needs is each kernel's shared memory a block at the
          variant the kernels' own selectors pick for its shapes
          (``fused_variant``, ``gat_variant``, ``sg_variant`` and their
          size functions), so the plan and the kernels cannot disagree;
          a model for which no variant fits a block's 232,448 bytes is
          refused.
  Step 3 (N_pe): the subgraphs a batch needs so that compute hides one
          sweep of the weights, from the reference's cost model
          (``layer_costs``) against the card's peaks. In the card's terms:
          at Fout=256 a batch of C=64 gives the tf32x3 kernel 4 column
          tiles x 64 = 256 blocks, one a SM at 197 KB of shared memory, so
          1.94 waves over 132 SMs; C is the grid's second dimension, and
          each further 33 subgraphs at Fout=256 fill another wave.

Peaks are NVIDIA's published numbers for the H100 SXM (dense, at its 700 W
limit), the same values chip_smoke.py's bounds use; a card set to a lower
power limit runs below them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.program import (AttentionSoftmax, Transform, lower,
                                      program_alu_ops)
from repro_torch.gnn.model import GNNConfig
from repro_torch.kernels import build
from repro_torch.kernels import fused_gnn, gat_attention, scatter_gather

# scalar primitives the card's CUDA cores (elementwise, reductions) and
# tensor cores (matmul) cover: the "N_ALU" feasibility vocabulary. The
# per-model required set is derived from the model's lowered AckProgram
# (core.program.program_alu_ops).
H100_OPS = {"matmul", "add", "relu", "mul", "exp", "max", "leaky_relu",
            "min", "sub", "div"}
F_ALIGN = 128               # f_pad: the engine pads f_in as the reference


@dataclass(frozen=True)
class H100Spec:
    """One NVIDIA H100 SXM (published peaks, dense, 700 W)."""
    name: str = "nvidia-h100-sxm"
    peak_bf16: float = 989e12           # FLOP/s, tensor cores
    peak_tf32: float = 494.7e12         # FLOP/s, tensor cores
    peak_fp32: float = 67e12            # FLOP/s, CUDA cores
    hbm_bw: float = 3.35e12             # bytes/s
    hbm_bytes: int = 80 * 10 ** 9
    sms: int = 132
    max_smem: int = build.MAX_SMEM      # bytes a block may have

    @property
    def peak_flops(self) -> float:
        """The rate of the engine's fp32 products: the fused layer's
        tf32x3 kernel issues three tf32 products per multiply-add."""
        return self.peak_tf32 / 3


@dataclass
class DSEPlan:
    block_f: int                        # p_sys analogue: columns a block
    c_core: int                         # N_pe analogue: subgraphs a batch
    edge_block: int                     # edges a warp takes a step (sg)
    buffer_depth: int                   # stages of the fused kernel's ring
    smem_used: int                      # largest shared memory a block
    ops_ok: bool
    per_model: Dict[str, dict] = field(default_factory=dict)


class PlanViolation(ValueError):
    """A model does not fit under the shared DSEPlan."""


def _f_pad(f: int) -> int:
    return f + (-f) % F_ALIGN


def smem_working_set(cfg: GNNConfig, e_pad: Optional[int] = None
                     ) -> Dict[str, int]:
    """Shared memory (bytes) of one block of each kernel ``cfg``'s program
    can launch, at the variant the kernel's selector picks for its shapes:
    the fused layer at N and the padded input width, GAT's attention at N
    and the hidden width, and, given the edge budget ``e_pad``, the
    scatter-gather (the bucket variant keeps its scratch in device memory
    and takes no dynamic shared memory)."""
    n = cfg.receptive_field
    prog = lower(cfg)
    # the widest input the fused layer sees: layer 0's padded features
    out = {"fused_gnn_layer": fused_gnn.SMEM_BYTES[fused_gnn.fused_variant(
        n, _f_pad(max(cfg.f_in, cfg.f_hidden)), neigh=True)]}
    if any(isinstance(op, AttentionSoftmax) for _, op in prog.ops):
        v = gat_attention.gat_variant(n, cfg.f_hidden, cfg.n_heads,
                                      aligned=True)
        out["gat_attention"] = (gat_attention.slab_smem_bytes if v == "slab"
                                else gat_attention.row_smem_bytes)(n)
    if e_pad is not None:
        out["scatter_gather_aggregate"] = scatter_gather.sort_smem_bytes(
            n, e_pad, scatter_gather.sort_block_cols(n, e_pad)) \
            if scatter_gather.sg_variant(n, e_pad) == "sort" else 0
    return out


def plan_covers(plan: DSEPlan, cfg: GNNConfig, spec: H100Spec = H100Spec(),
                e_pad: Optional[int] = None) -> List[str]:
    """Why ``cfg`` does NOT run under ``plan`` (empty list = covered).

    The serving-time admission check: a multi-model deployment keeps ONE
    plan (paper: one bitstream), and every registered model must (a) use
    only ops the plan's ALU set supports and (b) find, for every kernel its
    program launches, a variant whose block fits the card's shared memory.
    """
    reasons: List[str] = []
    try:
        ops = program_alu_ops(cfg)
    except KeyError as e:                 # no registered lowering: the
        reasons.append(str(e).strip('"'))  # message names the fix
        return reasons
    if not ops <= H100_OPS:
        reasons.append(f"ops {sorted(ops - H100_OPS)} unsupported")
    for kernel, nbytes in smem_working_set(cfg, e_pad).items():
        if nbytes > spec.max_smem:
            reasons.append(
                f"{kernel}: {nbytes} bytes of shared memory a block > "
                f"{spec.max_smem} (N={cfg.receptive_field}, "
                f"f_hidden={cfg.f_hidden}, heads={cfg.n_heads})")
    return reasons


def validate_models(plan: DSEPlan, models: Sequence[GNNConfig],
                    spec: H100Spec = H100Spec(),
                    e_pads: Optional[Sequence[Optional[int]]] = None
                    ) -> None:
    """Raise PlanViolation unless every model runs under the one plan."""
    if not plan.ops_ok:
        raise PlanViolation("plan was built over an unsupported op set")
    e_pads = list(e_pads) if e_pads is not None else [None] * len(models)
    bad = {m.display: plan_covers(plan, m, spec, e)
           for m, e in zip(models, e_pads)}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        raise PlanViolation(f"models outside the shared plan: {bad}")


def layer_costs(cfg: GNNConfig, n: int, f_in: int, f_out: int,
                spec: H100Spec, *, section: str = "auto") -> dict:
    """Per-layer dense-mode compute/memory model for one subgraph, summed
    over the ops of the model's lowered layer template (the reference's
    model: ``flops`` and ``bytes`` do not depend on the card). The feature
    width is tracked through the op stream as specialize() does: each
    Transform re-widens to f_out. ``section`` picks the template ("layer0"
    | "inner"); "auto" infers it (layer0 iff f_in != f_out)."""
    prog = lower(cfg)
    if section == "auto":
        section = "layer0" if f_in != f_out or cfg.n_layers == 1 \
            else "inner"
    ops_seq = prog.layer0 if section == "layer0" else prog.inner
    flops, f_cur = 0.0, f_in
    for op in ops_seq:
        flops += op.dense_flops(n, f_cur, f_out)
        if isinstance(op, Transform):
            f_cur = f_out
    # device traffic: H in/out + A once; weights amortized over C subgraphs
    bytes_hbm = 4.0 * (n * f_in + n * f_out + n * n)
    return {"flops": flops, "bytes": bytes_hbm,
            "t_compute": flops / spec.peak_flops,
            "t_memory": bytes_hbm / spec.hbm_bw}


def explore(models: Sequence[GNNConfig], spec: H100Spec = H100Spec(),
            e_pads: Optional[Sequence[Optional[int]]] = None) -> DSEPlan:
    # Step 1: op coverage, from each model's lowered instruction stream
    ops_ok = all(program_alu_ops(m) <= H100_OPS for m in models)
    e_pads = list(e_pads) if e_pads is not None else [None] * len(models)

    # Step 2: the fused kernel's column block is fixed by its tiling; the
    # plan records the largest block any model's kernels need
    smem = max(max(smem_working_set(m, e).values())
               for m, e in zip(models, e_pads))

    # Step 3: subgraphs a batch so that compute hides one weight sweep
    per_model = {}
    c_core = 8
    for m in models:
        n = m.receptive_field
        costs = [layer_costs(m, n, m.f_in, m.f_hidden, spec,
                             section="layer0")] + \
            [layer_costs(m, n, m.f_hidden, m.f_hidden, spec,
                         section="inner")] * (m.n_layers - 1)
        t_comp = sum(c["t_compute"] for c in costs)
        t_mem = sum(c["t_memory"] for c in costs)
        w_bytes = 4.0 * (m.f_in * m.f_hidden
                         + (m.n_layers - 1) * m.f_hidden * m.f_hidden)
        t_weights = w_bytes / spec.hbm_bw
        need = max(1, int(2 * t_weights / max(t_comp, 1e-12)))
        c_core = max(c_core, min(256, need))
        util = t_comp / max(t_comp, t_mem + t_weights / max(need, 1))
        per_model[m.display] = {
            "t_compute_per_target": t_comp, "t_memory_per_target": t_mem,
            "modeled_util": round(util, 3),
            "bound": "compute" if t_comp >= t_mem else "memory",
        }
    return DSEPlan(block_f=fused_gnn.TILE_N, c_core=c_core, edge_block=32,
                   buffer_depth=2, smem_used=smem, ops_ok=ops_ok,
                   per_model=per_model)
