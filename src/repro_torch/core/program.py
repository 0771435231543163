"""AckProgram IR — every GNN compiles to a typed ACK instruction stream.

The PyTorch counterpart of ``repro.core.program``: the same op vocabulary,
the same lowering registry and the same per-op dense/sg specialization, so
a model lowers to the same program in both packages. The executor runs a
specialized program with plain PyTorch ops (``impl="torch"``, the
counterpart of the reference's ``"xla"``) or through the package's CUDA
kernels (``impl="cuda"``, the counterpart of ``"pallas"``): under
``"cuda"`` a dense Aggregate[+Residual]+Transform group is peephole-fused
into ONE ``kernels.ops.fused_gnn_layer`` call, every standalone Transform
runs the same kernel (one with ``w_self`` on [src | h_in] through the two
weights stacked, ``stack_self_weights``), sg Aggregates run the scatter-gather kernel, an
AttentionScore + dense AttentionSoftmax pair runs as ONE launch of the GAT kernel's fused form (``kernels.ops.
gat_attention_layer``) where its shapes fit and a lone dense
AttentionSoftmax runs the GAT kernel; everything else is plain PyTorch on
both impls, as it is outside Pallas in the reference.

  ``lower(cfg)``        GNNConfig -> AckProgram, via a model *registry*
                        (``@register_lowering("gat")``).
  ``specialize(prog)``  sets the per-op mode mux from each kernel's FLOP
                        model (core.ack.choose_mode), from measured p50s
                        (``measured=``, a calibration table) or the
                        caller's force.
  ``execute(prog)``     one executor runs any specialized program; the
                        inner layers loop over index ``l`` of the stacked
                        ``params["layers"]`` (the reference's ``lax.scan``).
                        ``blocks=`` passes tuned kernel block sizes.

The op vocabulary is the paper's kernel taxonomy: Aggregate (FA),
Transform (FT), AttentionScore + AttentionSoftmax (Attention), Residual,
Readout, Classify.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as TF

from repro_torch.core.ack import choose_mode
from repro_torch.gnn.layers import NEG_INF, _ft, agg_dense, agg_sg, readout

ACTS = {"none": lambda x: x, "relu": torch.relu, "elu": TF.elu}
IMPLS = ("torch", "cuda")

# scalar ALU primitives each activation decomposes into (the DSE "N_ALU"
# feasibility vocabulary of the reference)
_ACT_ALU = {"none": frozenset(), "relu": frozenset({"relu"}),
            "elu": frozenset({"exp", "sub", "max"})}


# ---------------------------------------------------------------------------
# the instruction set


@dataclass(frozen=True)
class AckOp:
    """Base ACK instruction. ``mux`` marks ops with a dense/sg datapath
    choice; everything else executes in exactly one mode."""

    @property
    def mux(self) -> bool:
        return False

    @property
    def alu(self) -> frozenset:
        return frozenset()

    def dense_flops(self, n: int, f_in: int, f_out: int) -> float:
        return 0.0

    def describe(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class Aggregate(AckOp):
    """Feature Aggregation kernel: z = A_norm @ h (dense/systolic) or an
    edge-list scatter-gather (sg). ``norm`` picks the adjacency:
    ``gcn`` (sym-normalized + self loops), ``mean`` (row-stochastic),
    ``binary`` (0/1 structure)."""
    norm: str = "gcn"
    src: str = "h"
    out: str = "z"
    mode: Optional[str] = None          # dense | sg | None = unspecialized

    @property
    def mux(self) -> bool:
        return True

    @property
    def alu(self) -> frozenset:
        return frozenset({"matmul", "add", "mul"})

    def dense_flops(self, n, f_in, f_out):
        return 2.0 * n * n * f_in

    def describe(self) -> str:
        return f"Aggregate[{self.norm}]"


@dataclass(frozen=True)
class Residual(AckOp):
    """into = (1 + p[eps_param]) * src + into_gain * into  (GIN's
    (1+eps)-weighted self term at the default into_gain=1; plain residual
    when ``eps_param`` is None). ``src`` may name the ``h0`` register —
    the propagation ENTRY state (the layer-0 prediction inside the inner
    scan), which is what APPNP's teleport term reads. ``into_gain`` is a
    compile-time constant (e.g. 1 - alpha), not a parameter."""
    src: str = "h_in"
    into: str = "z"
    eps_param: Optional[str] = None
    into_gain: float = 1.0

    @property
    def alu(self) -> frozenset:
        return frozenset({"add", "mul"})

    def dense_flops(self, n, f_in, f_out):
        return 2.0 * n * f_in


@dataclass(frozen=True)
class Transform(AckOp):
    """Feature Transformation kernel: out = act(src @ p[w] [+ h_in @
    p[w_self]] + p[b]). ALWAYS systolic — a dense matmul is the one case
    the paper never runs through the scatter-gather pipelines."""
    w: str = "w"
    b: Optional[str] = None
    act: str = "relu"                   # none | relu | elu
    src: str = "z"
    out: str = "h"
    w_self: Optional[str] = None        # applied to the layer input
    masked: bool = True
    mode: str = "dense"                 # fixed: systolic

    @property
    def alu(self) -> frozenset:
        return frozenset({"matmul", "add"}) | _ACT_ALU[self.act]

    def dense_flops(self, n, f_in, f_out):
        per = 2.0 * n * f_in * f_out
        return per * (2.0 if self.w_self else 1.0)

    def describe(self) -> str:
        return f"Transform[{self.w}]"


@dataclass(frozen=True)
class AttentionScore(AckOp):
    """Per-vertex attention score terms s_src/s_dst = <z_head, a_*> (GAT).
    Tiny per-head reductions — VPU work, no mode mux."""
    a_src: str = "a_src"
    a_dst: str = "a_dst"
    src: str = "z"
    n_heads: int = 1

    @property
    def alu(self) -> frozenset:
        return frozenset({"matmul", "add", "mul"})

    def dense_flops(self, n, f_in, f_out):
        return 4.0 * n * f_out


@dataclass(frozen=True)
class AttentionSoftmax(AckOp):
    """Edge-score LeakyReLU + masked softmax over incoming edges + weighted
    aggregation of z (the paper's Attention kernel). Dense mode builds the
    full [N, N] score matrix (matmul-friendly at decoupled N); sg mode is
    edge-parallel segment-max/sum."""
    b: Optional[str] = "b"
    act: str = "elu"
    negative_slope: float = 0.2
    src: str = "z"
    out: str = "h"
    n_heads: int = 1
    mode: Optional[str] = None

    @property
    def mux(self) -> bool:
        return True

    @property
    def alu(self) -> frozenset:
        return (frozenset({"leaky_relu", "exp", "max", "add", "mul", "div"})
                | _ACT_ALU[self.act])

    def dense_flops(self, n, f_in, f_out):
        return 2.0 * n * n * f_out + 8.0 * n * n * self.n_heads

    def describe(self) -> str:
        return f"AttentionSoftmax[h{self.n_heads}]"


@dataclass(frozen=True)
class Readout(AckOp):
    """Receptive-field readout (paper: elementwise Max over the subgraph)."""
    kind: str = "max"

    @property
    def alu(self) -> frozenset:
        return {"max": frozenset({"max"}),
                "mean": frozenset({"add", "mul", "div"}),
                "target": frozenset()}[self.kind]

    def describe(self) -> str:
        return f"Readout[{self.kind}]"


@dataclass(frozen=True)
class Classify(AckOp):
    """Final linear classifier over the readout embedding."""
    w: str = "cls_w"
    b: str = "cls_b"

    @property
    def alu(self) -> frozenset:
        return frozenset({"matmul", "add"})


@dataclass(frozen=True)
class AckProgram:
    """A compiled GNN: the layer-0 op stream (f_in -> f_hidden), the inner
    op stream (executed L-1 times, once per index of the stacked
    inner weights), and the tail (Readout [+ Classify])."""
    kind: str
    layer0: Tuple[AckOp, ...]
    inner: Tuple[AckOp, ...]
    tail: Tuple[AckOp, ...]
    n_layers: int

    def layer_sections(self):
        yield "layer0", self.layer0
        if self.n_layers > 1:
            yield "inner", self.inner

    @property
    def ops(self) -> Tuple[Tuple[str, AckOp], ...]:
        """Every EXECUTED op with its site label — the inner section is
        excluded for 1-layer programs (execute() never runs it), so
        decisions, required_adjacency, and the ALU set all describe the
        datapath that actually runs."""
        out = []
        for sec, seq in (*self.layer_sections(), ("tail", self.tail)):
            out += [(f"{sec}[{i}]", op) for i, op in enumerate(seq)]
        return tuple(out)

    @property
    def specialized(self) -> bool:
        return all(op.mode is not None for _, op in self.ops
                   if op.mux)


# ---------------------------------------------------------------------------
# model registry: kind -> (lowering, per-layer param init)


@dataclass
class ModelLowering:
    kind: str
    lower: Callable
    layer_init: Callable        # (cfg, key, f_in, f_out) -> param dict


_REGISTRY: Dict[str, ModelLowering] = {}
_BUILTINS_LOADED = False


def register_lowering(kind: str, *, layer_init: Callable):
    """Decorator: register ``fn(cfg) -> AckProgram`` as the lowering for
    model kind ``kind``, together with the per-layer parameter initializer
    ``layer_init(cfg, key, f_in, f_out)``. Registering a kind makes it
    servable everywhere — engine, DSE admission, GNNServer — with no other
    code change."""
    def deco(fn):
        _REGISTRY[kind] = ModelLowering(kind, fn, layer_init)
        lower.cache_clear()     # re-registration must not serve a stale
        return fn               # cached program for this kind
    return deco


def _ensure_builtins():
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        import repro_torch.gnn.lowering  # noqa: F401 — registers builtins
        _BUILTINS_LOADED = True


def lowering_for(kind: str) -> ModelLowering:
    _ensure_builtins()
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise KeyError(
            f"no registered lowering for model kind {kind!r}; registered "
            f"kinds: {registered_kinds()}. Add one with "
            f"@register_lowering({kind!r}, layer_init=...) — see "
            f"repro_torch/gnn/lowering.py for the builtin lowerings.") from None


def registered_kinds() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def layer_init_for(kind: str) -> Callable:
    return lowering_for(kind).layer_init


@functools.lru_cache(maxsize=256)
def lower(cfg) -> AckProgram:
    """Compile ``cfg`` (a frozen GNNConfig) into its unspecialized
    AckProgram via the registry."""
    prog = lowering_for(cfg.kind).lower(cfg)
    if not any(isinstance(op, Readout) for op in prog.tail):
        raise ValueError(f"lowering for {cfg.kind!r} emitted no Readout")
    for sec, seq in prog.layer_sections():
        if not any(getattr(op, "out", None) == "h" for op in seq):
            # a layer that never writes the "h" register would silently
            # become the identity (execute returns regs["h"], pre-seeded
            # with the layer input) — a one-token out= mistake in a
            # custom lowering must fail loudly, not serve wrong numbers
            raise ValueError(
                f"lowering for {cfg.kind!r}: {sec} ops never write the "
                f"'h' register — the layer would be an identity. Set "
                f"out='h' on the final op.")
    return prog


def program_alu_ops(cfg) -> frozenset:
    """Union of scalar ALU primitives the lowered program requires — the
    DSE Step-1 ("N_ALU") feasibility set, derived from the instruction
    stream instead of a hand-kept table."""
    return frozenset().union(*(op.alu for _, op in lower(cfg).ops))


def input_width_params(prog: AckProgram) -> Tuple[str, ...]:
    """Names of layer0 weight params whose ROWS are sized by the layer
    input width f_in — the ones the engine must row-pad when it pads
    features for kernel alignment. Derived by tracking which registers still
    carry the input width through the op stream (Aggregate preserves its
    source's width; Transform re-widens its output to f_out)."""
    at_input = {"h", "h_in", "h0"}     # h0 == the layer input in layer0
    keys = []
    for op in prog.layer0:
        if isinstance(op, Aggregate):
            if op.src in at_input:
                at_input.add(op.out)
            else:
                at_input.discard(op.out)
        elif isinstance(op, Residual):
            if op.src not in at_input:
                at_input.discard(op.into)
        elif isinstance(op, Transform):
            if op.src in at_input:
                keys.append(op.w)
            if op.w_self:               # always reads h_in
                keys.append(op.w_self)
            at_input.discard(op.out)
        elif isinstance(op, AttentionSoftmax):
            at_input.discard(op.out)
    return tuple(dict.fromkeys(keys))


def required_adjacency(prog: AckProgram) -> Tuple[str, ...]:
    """Which dense [C,N,N] adjacency arrays the program reads — lets
    serving ship only what the compiled datapath touches. Ops already
    specialized to sg mode don't count (their data is the edge list);
    unspecialized ops count conservatively."""
    keys = set()
    for _, op in prog.ops:
        if getattr(op, "mode", None) == "sg":
            continue
        if isinstance(op, Aggregate):
            keys.add("adj" if op.norm == "gcn" else "adj_mean")
        elif isinstance(op, AttentionSoftmax):
            keys.add("adj_mean")            # structural mask source
    return tuple(sorted(keys))


# ---------------------------------------------------------------------------
# specialization: the per-op mode mux


@dataclass(frozen=True)
class OpDecision:
    site: str                   # e.g. "layer0[0]"
    op: str                     # e.g. "Aggregate[gcn]"
    mode: str                   # dense | sg
    mux: bool                   # had a real dense/sg choice
    dense_flops: float
    sg_flops: float
    reason: str


@dataclass(frozen=True)
class ProgramDecision:
    """Per-op mode decisions for one specialized program (the
    ``InferenceResult.decision`` payload): a sequence of OpDecisions plus
    summary views. Back-compat: ``.mode`` and ``.reason`` keep the old
    single-decision spelling."""
    kind: str
    ops: Tuple[OpDecision, ...]

    def __iter__(self):
        return iter(self.ops)

    def __len__(self):
        return len(self.ops)

    def __getitem__(self, i):
        return self.ops[i]

    @property
    def mode(self) -> str:
        """Aggregate view over the MUX'D ops: dense | sg | mixed."""
        muxed = {d.mode for d in self.ops if d.mux}
        if not muxed or muxed == {"dense"}:
            return "dense"
        if muxed == {"sg"}:
            return "sg"
        return "mixed"

    @property
    def modes(self) -> Tuple[str, ...]:
        return tuple(sorted({d.mode for d in self.ops}))

    @property
    def n_dense(self) -> int:
        return sum(d.mode == "dense" for d in self.ops)

    @property
    def n_sg(self) -> int:
        return sum(d.mode == "sg" for d in self.ops)

    @property
    def summary(self) -> str:
        return (f"{self.kind}: {len(self.ops)} ops, "
                f"{self.n_dense} dense + {self.n_sg} sg ({self.mode})")

    @property
    def reason(self) -> str:
        for d in self.ops:
            if d.mux:
                return d.reason
        return "no mux'd ops"


ForceSpec = Union[None, str, Dict[str, str]]

# kernel block overrides threaded through the executor: {"block_f":
# int|None, "block_cols": int|None} (the fused layer's output-column
# grouping and the sort scatter-gather's columns a block, the port's
# counterparts of the reference's block_f and block_e). None / missing keys
# keep the kernels' defaults, so blocks=None is exactly the path without
# autotune. block_cols reaches the sg Aggregates, whose width autotune
# times; the sg softmax's sums (one head's columns) keep the kernel's
# default, which follows their width.
BlockSpec = Optional[Dict[str, Optional[int]]]


def mux_sites(prog: AckProgram) -> Tuple[str, ...]:
    """Site labels of every EXECUTED op with a dense/sg mux — the keys a
    per-batch mode assignment must cover (tier/tail ops never mux)."""
    return tuple(site for site, op in prog.ops if op.mux)


def respecialize(prog: AckProgram, modes: Dict[str, str]) -> AckProgram:
    """Cheap per-batch re-specialization: return ``prog`` with the mux
    mode of each listed site replaced (``{"layer0[0]": "sg", ...}``).
    Sites not listed keep their existing mode, so re-specializing an
    already-specialized program always yields a fully specialized one —
    per-batch dispatch makes its program variants this way: the mode
    vector changes per batch but the op stream never does."""
    unknown = set(modes) - {f"{sec}[{i}]"
                            for sec, seq in (("layer0", prog.layer0),
                                             ("inner", prog.inner),
                                             ("tail", prog.tail))
                            for i in range(len(seq))}
    if unknown:
        raise KeyError(f"unknown program sites {sorted(unknown)}")
    new_secs = {}
    for sec, seq in (("layer0", prog.layer0), ("inner", prog.inner),
                     ("tail", prog.tail)):
        ops = []
        for i, op in enumerate(seq):
            m = modes.get(f"{sec}[{i}]")
            if m is not None:
                if not op.mux:
                    raise ValueError(
                        f"{sec}[{i}] ({op.describe()}) has no dense/sg "
                        f"mux — only Aggregate/AttentionSoftmax modes "
                        f"can be re-specialized")
                if m not in ("dense", "sg"):
                    raise ValueError(f"mode {m!r} for {sec}[{i}]")
                op = replace(op, mode=m)
            ops.append(op)
        new_secs[sec] = tuple(ops)
    return replace(prog, layer0=new_secs["layer0"],
                   inner=new_secs["inner"], tail=new_secs["tail"])


def _forced(force: ForceSpec, site: str, opname: str) -> Optional[str]:
    if force is None:
        return None
    if isinstance(force, str):
        return force
    return force.get(site) or force.get(opname.split("[")[0])


def specialize(prog: AckProgram, *, n: int, avg_edges: float = 0.0,
               f_in: Optional[int] = None, f_hidden: int = 256,
               force: ForceSpec = None, measured=None,
               measured_impl: str = "torch",
               measured_bucket: Optional[int] = None
               ) -> Tuple[AckProgram, ProgramDecision]:
    """Set every op's mode mux. Mux'd ops (Aggregate, AttentionSoftmax)
    each get their own dense/sg decision from their kernel's FLOP model at
    that op's feature width; Transform and friends are recorded as dense.
    ``force`` is None (auto), "dense"/"sg" (all mux'd ops), or a dict keyed
    by site ("layer0[0]") or op class name ("Aggregate").

    ``measured`` is an optional ``obs.calib.CalibrationTable``: when BOTH
    the dense and sg cells for a mux'd op are populated (keyed by op class
    name, at ``measured_impl`` / ``measured_bucket``), their measured p50s
    override the static FLOP model for that op. Partially populated or
    absent cells fall back to the FLOP model per op; an explicit ``force``
    always wins."""
    f_in = f_in if f_in is not None else f_hidden

    def _measured_mode(op):
        """(mode, reason) from measured p50s, or None to use the FLOP
        model for this op."""
        if measured is None:
            return None
        cls = type(op).__name__
        td = measured.lookup(cls, f"{measured_impl}/dense",
                             measured_bucket)
        ts = measured.lookup(cls, f"{measured_impl}/sg", measured_bucket)
        if td is None and isinstance(op, AttentionSoftmax):
            # under impl="cuda" the dense softmax is timed grouped with its
            # scores (compile_steps), under the group's label; the sg side
            # then pays its separately timed scores too
            td = measured.lookup(ATTENTION_GROUP, f"{measured_impl}/dense",
                                 measured_bucket)
            score = measured.lookup(AttentionScore.__name__,
                                    f"{measured_impl}/-", measured_bucket)
            ts = None if ts is None or score is None else ts + score
        if td is None or ts is None:
            return None
        mode = "dense" if td <= ts else "sg"
        return mode, (f"measured p50 {measured_impl} dense={td:.3e}s vs "
                      f"sg={ts:.3e}s -> {mode}")

    decisions = []
    new_secs: Dict[str, Tuple[AckOp, ...]] = {}
    for sec, seq in (("layer0", prog.layer0), ("inner", prog.inner),
                     ("tail", prog.tail)):
        # a 1-layer program's inner section never executes: its ops still
        # get modes (the stored program stays fully specialized) but no
        # decisions are recorded for them
        executed = sec != "inner" or prog.n_layers > 1
        # track the feature width flowing through the op stream: a
        # Transform re-widens to f_hidden, so ops after it (e.g. gat's
        # attention pair) see the transformed width in their FLOP models
        f_cur = f_in if sec == "layer0" else f_hidden
        new_ops = []
        for i, op in enumerate(seq):
            site = f"{sec}[{i}]"
            name = op.describe()
            if op.mux:
                d = choose_mode(n, avg_edges, f_cur,
                                force=_forced(force, site, name))
                mode, reason = d.mode, d.reason
                if _forced(force, site, name) is None:
                    m = _measured_mode(op)
                    if m is not None:
                        mode, reason = m
                op = replace(op, mode=mode)
                if executed:
                    decisions.append(OpDecision(
                        site, name, mode, True, d.dense_flops,
                        d.sg_flops, reason))
            elif executed:
                fl = op.dense_flops(n, f_cur, f_hidden)
                decisions.append(OpDecision(
                    site, name, "dense", False, fl, fl,
                    "systolic (FT and friends are always dense)"))
            if isinstance(op, Transform):
                f_cur = f_hidden
            new_ops.append(op)
        new_secs[sec] = tuple(new_ops)
    sprog = replace(prog, layer0=new_secs["layer0"],
                    inner=new_secs["inner"], tail=new_secs["tail"])
    return sprog, ProgramDecision(prog.kind, tuple(decisions))


# ---------------------------------------------------------------------------
# the executor: one interpreter over both kernel families


def _adjacency(norm: str, batch):
    if norm == "gcn":
        return batch["adj"]
    if norm == "mean":
        return batch["adj_mean"]
    if norm == "binary":
        return torch.sign(batch["adj_mean"])
    raise ValueError(f"unknown aggregate norm {norm!r}")


def _sg_weights(norm: str, batch):
    if norm == "gcn":
        return batch["edge_w"]
    if norm == "mean":
        return batch["edge_w_mean"]
    return torch.ones_like(batch["edge_w"]) * (batch["edge_w"] != 0)


def _struct(batch, mask, n, like):
    """GAT's structural mask: in-edges plus self loops, real columns only."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return (torch.sign(batch["adj_mean"]) + eye) * mask[:, None, :]


def _block_kw(blocks: BlockSpec, key: str) -> dict:
    """Kernel kwargs for a tuned block size (empty = the defaults)."""
    if blocks and blocks.get(key):
        return {key: int(blocks[key])}
    return {}


def _step_aggregate(op: Aggregate, impl: str, blocks: BlockSpec = None):
    from repro_torch.kernels import ops as kops
    bkw = _block_kw(blocks, "block_cols")

    def step(p, regs, batch):
        h = regs[op.src]
        if op.mode == "dense":
            regs[op.out] = agg_dense(_adjacency(op.norm, batch), h)
            return
        w = _sg_weights(op.norm, batch)
        if impl == "cuda":
            z = kops.scatter_gather_aggregate(batch["edge_src"],
                                              batch["edge_dst"], w, h,
                                              **bkw)
        else:
            z = agg_sg(batch["edge_src"], batch["edge_dst"], w, h,
                       h.shape[1])
        if op.norm == "gcn":
            # self-loop term is baked into adj in dense mode; the edge
            # list excludes it, so add explicitly
            z = z + h * batch["self_w"][..., None]
        regs[op.out] = z
    return step


def _step_residual(op: Residual):
    def step(p, regs, batch):
        scale = (1.0 + p[op.eps_param]) if op.eps_param else 1.0
        regs[op.into] = scale * regs[op.src] \
            + op.into_gain * regs[op.into]
    return step


def stacked_key(op: Transform) -> str:
    """The params key of a ``w_self`` Transform's two weights stacked
    [w; w_self] (``stack_self_weights``)."""
    return f"{op.w}+{op.w_self}"


def stack_self_weights(prog: AckProgram, params):
    """``params`` with each ``w_self`` Transform's weights also stacked,
    [w; w_self] along the input rows, under ``stacked_key`` in its layer's
    dict (the stacked ``layers`` along their rows too): under impl="cuda"
    such a Transform is one self-only call of the fused kernel on
    [src | h_in]. The engine stacks them once, when it places its
    parameters; a program run on params without them stacks them on each
    call."""
    out = dict(params)
    for name, seq in (("layer0", prog.layer0), ("layers", prog.inner)):
        ops = [op for op in seq if isinstance(op, Transform) and op.w_self]
        if ops and name in params:
            layer = dict(params[name])
            with torch.no_grad():
                for op in ops:
                    layer[stacked_key(op)] = torch.cat(
                        (layer[op.w], layer[op.w_self]), dim=-2)
            out[name] = layer
    return out


def _step_transform(op: Transform, impl: str, blocks: BlockSpec = None):
    from repro_torch.kernels import ops as kops
    bkw = _block_kw(blocks, "block_f")

    if impl == "cuda" and op.w_self is None:
        # pure single-input transform through the fused kernel's W_self
        # slot (no adjacency). The kernel always applies the row mask;
        # with masked=False this differs from the plain path on PADDED
        # rows only, which never reach the embeddings (adjacency columns
        # and the readout both mask them) — as in the reference.
        def step(p, regs, batch):
            h = regs[op.src]
            regs[op.out] = kops.fused_gnn_layer(
                None, h, None, p[op.w], p[op.b] if op.b else None,
                batch["mask"], act=op.act, **bkw)
        return step

    if impl == "cuda":
        # a transform with w_self (GraphSAGE after an sg Aggregate) as one
        # self-only call of the fused kernel: [src | h_in] through the
        # stacked weights [w; w_self] (stack_self_weights), so the kernel
        # sums src W + h_in W_self + b
        key = stacked_key(op)

        def step(p, regs, batch):
            x = torch.cat((regs[op.src], regs["h_in"]), dim=-1)
            w = p[key] if key in p else torch.cat((p[op.w], p[op.w_self]))
            regs[op.out] = kops.fused_gnn_layer(
                None, x, None, w, p[op.b] if op.b else None,
                batch["mask"], act=op.act, **bkw)
        return step

    def step(p, regs, batch):
        src = regs[op.src]
        b = p[op.b] if op.b else None
        if op.w_self:
            out = _ft(regs["h_in"], p[op.w_self], b) + _ft(src, p[op.w])
        else:
            out = _ft(src, p[op.w], b)
        out = ACTS[op.act](out)
        if op.masked:
            out = out * batch["mask"][..., None]
        regs[op.out] = out
    return step


def _fused_step(agg: Aggregate, res: Optional[Residual], tf: Transform,
                blocks: BlockSpec = None):
    """Kernel peephole: dense Aggregate [+ Residual] + Transform as ONE
    fused kernel call (A @ (H @ W) association, see kernels/fused_gnn.py)."""
    from repro_torch.kernels import ops as kops
    bkw = _block_kw(blocks, "block_f")

    def step(p, regs, batch):
        h = regs[agg.src]
        a = _adjacency(agg.norm, batch)
        if res is not None:
            n = h.shape[1]
            scale = (1.0 + p[res.eps_param]) if res.eps_param else 1.0
            a = a + scale * torch.eye(n, dtype=h.dtype, device=h.device)
        regs[tf.out] = kops.fused_gnn_layer(
            a, h, p[tf.w], p[tf.w_self] if tf.w_self else None,
            p[tf.b] if tf.b else None, batch["mask"], act=tf.act, **bkw)
    return step


def _step_attention_score(op: AttentionScore):
    def step(p, regs, batch):
        z = regs[op.src]
        C, N, F = z.shape
        z4 = z.reshape(C, N, op.n_heads, F // op.n_heads)
        regs["s_src"] = torch.einsum("cnhf,hf->cnh", z4, p[op.a_src])
        regs["s_dst"] = torch.einsum("cnhf,hf->cnh", z4, p[op.a_dst])
    return step


def _step_attention_softmax(op: AttentionSoftmax, impl: str):
    from repro_torch.kernels import ops as kops

    def finish(out, p, batch):
        out = out + p[op.b] if op.b else out
        return ACTS[op.act](out) * batch["mask"][..., None]

    if op.mode == "dense" and impl == "cuda":
        def step(p, regs, batch):
            z, mask = regs[op.src], batch["mask"]
            struct = _struct(batch, mask, z.shape[1], z)
            out = kops.gat_attention(
                z, regs["s_src"].contiguous(), regs["s_dst"].contiguous(),
                struct, n_heads=op.n_heads,
                negative_slope=op.negative_slope)
            regs[op.out] = finish(out, p, batch)
        return step

    if op.mode == "dense":
        def step(p, regs, batch):
            z, mask = regs[op.src], batch["mask"]
            C, N, F = z.shape
            nh = op.n_heads
            z4 = z.reshape(C, N, nh, F // nh)
            s_src, s_dst = regs["s_src"], regs["s_dst"]
            e = s_dst.permute(0, 2, 1)[:, :, :, None] \
                + s_src.permute(0, 2, 1)[:, :, None, :]
            e = TF.leaky_relu(e, op.negative_slope)
            emask = _struct(batch, mask, N, z)[:, None, :, :] > 0
            e = e.masked_fill(~emask, NEG_INF)
            attn = torch.softmax(e, dim=-1).masked_fill(~emask, 0.0)
            out = torch.einsum("chij,cjhf->cihf", attn, z4)
            regs[op.out] = finish(out.reshape(C, N, F), p, batch)
        return step

    # sg mode: edge-parallel segment softmax. Subgraph c's vertices are
    # rows c*N..c*N+N-1 of one flat segment axis. The segment max is
    # order-free; the segment sums (the softmax's denominator and
    # numerator) run under impl="cuda" in one launch of the scatter-gather
    # kernel with the (subgraph, head) pairs on its batch axis, which sums
    # each destination's edges in edge order: no atomics, one answer on
    # every run. The plain path sums with index_add_ (the reference's
    # segment_sum), whose order on a card is not fixed.
    def step(p, regs, batch):
        z = regs[op.src]
        C, N, F = z.shape
        nh = op.n_heads
        fh = F // nh
        dev = z.device
        valid = (batch["edge_w"] != 0).to(z.dtype)
        # self-loop handled by appending implicit (i, i) edges
        iota = torch.arange(N, device=dev, dtype=batch["edge_src"].dtype
                            ).expand(C, N)
        s_all = torch.cat([batch["edge_src"], iota], dim=1)
        d_all = torch.cat([batch["edge_dst"], iota], dim=1)
        v_all = torch.cat([valid, torch.ones((C, N), dtype=z.dtype,
                                             device=dev)], dim=1)
        off = (torch.arange(C, device=dev) * N)[:, None]
        fs = (s_all.long() + off).reshape(-1)
        fd = (d_all.long() + off).reshape(-1)
        ss = regs["s_src"].reshape(C * N, nh)
        sd = regs["s_dst"].reshape(C * N, nh)
        e = TF.leaky_relu(sd[fd] + ss[fs], op.negative_slope)
        v = v_all.reshape(-1, 1)
        e = e.masked_fill(v <= 0, NEG_INF)
        m = torch.full((C * N, nh), NEG_INF, dtype=z.dtype, device=dev)
        m = m.scatter_reduce(0, fd[:, None].expand(-1, nh), e, "amax",
                             include_self=False)
        ex = torch.exp(e - m[fd]) * v
        if impl == "cuda":
            out = _sg_softmax_sums(s_all, d_all, ex, z, nh)
        else:
            den = torch.zeros((C * N, nh), dtype=z.dtype,
                              device=dev).index_add_(0, fd, ex)
            alpha = ex / torch.clamp(den[fd], min=1e-20)
            upd = alpha[:, :, None] * z.reshape(C * N, nh, fh)[fs]
            out = torch.zeros((C * N, nh, fh), dtype=z.dtype,
                              device=dev).index_add_(0, fd, upd)
        regs[op.out] = finish(out.reshape(C, N, F), p, batch)
    return step


def _attention_step(score: AttentionScore, soft: AttentionSoftmax):
    """Kernel peephole: AttentionScore + dense AttentionSoftmax as ONE
    launch of the GAT kernel's fused form (scores, structure, softmax,
    aggregation, bias, activation and row mask; kernels/gat_attention.py).
    CPU tensors, and shapes it does not take on the card (bf16, a head
    wider than 64, N > 256), run the two steps as they run apart; each such
    step on the card is counted (``gat_attention.fused_fallbacks``)."""
    from repro_torch.kernels import gat_attention as kgat
    apart = (_step_attention_score(score),
             _step_attention_softmax(soft, "cuda"))

    def step(p, regs, batch):
        z, adj, mask = regs[soft.src], batch["adj_mean"], batch["mask"]
        a_src, a_dst = p[score.a_src], p[score.a_dst]
        b = p[soft.b] if soft.b else None
        if z.is_cuda and kgat.layer_fits(z, a_src, a_dst, adj, mask, b,
                                         n_heads=soft.n_heads):
            regs[soft.out] = kgat.launch_layer(
                z, a_src, a_dst, adj, mask, b, n_heads=soft.n_heads,
                negative_slope=soft.negative_slope, act=soft.act)
            return
        if z.is_cuda:
            kgat.note_fallback()
        for s in apart:
            s(p, regs, batch)
    return step


# the calibration label of the grouped step (``obs.calib.op_label``)
ATTENTION_GROUP = "AttentionScore+AttentionSoftmax"

# the caller name the sums' launches count under
# (``kernels.scatter_gather.caller_launches``)
SG_SOFTMAX_SUMS = "gat sg softmax sums"


def _sg_softmax_sums(s_all, d_all, ex, z, nh):
    """The sg softmax's segment sums in one scatter-gather launch, one item
    a (subgraph, head) pair: h = [z_head | 1 | 0...] (padded to a multiple
    of 4 columns) and w = ex give the numerator sum_e ex_e z[src_e] in the
    head's columns and the denominator sum_e ex_e in the ones column; the
    output is their quotient (denominator clamped at 1e-20, as the plain
    path's). A weight-0 edge is not walked but poisons its destination's
    numerator where z[src] is non-finite, as the plain path's 0 * z does.
    ``s_all``/``d_all`` [C, E'] int32 (the self loops appended), ``ex``
    [C*E', nh], z [C, N, F]; returns [C*N, nh, F/nh]."""
    from repro_torch.kernels import ops as kops
    C, N, F = z.shape
    fh = F // nh
    e_all = s_all.shape[1]
    src = s_all.unsqueeze(1).expand(C, nh, e_all).reshape(C * nh, e_all)
    dst = d_all.unsqueeze(1).expand(C, nh, e_all).reshape(C * nh, e_all)
    w = ex.float().reshape(C, e_all, nh).permute(0, 2, 1).reshape(
        C * nh, e_all)
    h = torch.zeros((C * nh, N, fh // 4 * 4 + 4), dtype=z.dtype,
                    device=z.device)
    h[..., :fh] = z.reshape(C, N, nh, fh).permute(0, 2, 1, 3).reshape(
        C * nh, N, fh)
    h[..., fh] = 1
    sums = kops.scatter_gather_aggregate(
        src.int().contiguous(), dst.int().contiguous(), w.contiguous(), h,
        caller=SG_SOFTMAX_SUMS)
    out = sums[..., :fh] / torch.clamp(sums[..., fh:fh + 1], min=1e-20)
    return out.reshape(C, nh, N, fh).permute(0, 2, 1, 3).reshape(
        C * N, nh, fh)


def _attention_pair(seq: Sequence[AckOp], i: int) -> bool:
    """seq[i] is an AttentionScore directly followed by a dense
    AttentionSoftmax over the same register and heads."""
    if i + 1 >= len(seq):
        return False
    score, soft = seq[i], seq[i + 1]
    return (isinstance(score, AttentionScore)
            and isinstance(soft, AttentionSoftmax) and soft.mode == "dense"
            and soft.src == score.src and soft.n_heads == score.n_heads)


def compile_steps(seq: Sequence[AckOp], impl: str,
                  blocks: BlockSpec = None):
    """Lower an op stream to labeled step closures: a list of
    ``(ops, step)`` pairs where ``ops`` is the tuple of AckOps the step
    executes (a singleton, or a group the kernel peephole fused into one
    kernel call: Aggregate[+Residual]+Transform, or an AttentionScore and
    the dense AttentionSoftmax right after it that reads the same register
    with as many heads). ``_compile_section``
    strips the labels for serving; ``obs.calib`` keeps them to time each
    step of a sampled pass. ``blocks`` threads autotuned block sizes into
    the kernel calls (``{"block_f": ..., "block_cols": ...}``; None = the
    kernels' defaults)."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}, expected one of {IMPLS}")
    steps = []
    i = 0
    while i < len(seq):
        op = seq[i]
        if (impl == "cuda" and isinstance(op, Aggregate)
                and op.mode == "dense" and i == 0
                and op.src in ("h", "h_in")):
            # fusion is only sound when the group reads the LAYER INPUT:
            # the fused kernel feeds one H to the aggregation, the folded
            # residual (A + scale*I), and W_self alike. At i == 0 the
            # "h"/"h_in" registers still hold the layer input.
            j, res = i + 1, None
            if (j < len(seq) and isinstance(seq[j], Residual)
                    and seq[j].into == op.out
                    and seq[j].src in ("h", "h_in")
                    and seq[j].into_gain == 1.0):
                # the fused kernel folds the residual as A + scale*I,
                # which assumes the aggregate term is unscaled
                res, j = seq[j], j + 1
            if (j < len(seq) and isinstance(seq[j], Transform)
                    and seq[j].src == op.out):
                group = tuple(o for o in (op, res, seq[j])
                              if o is not None)
                steps.append((group, _fused_step(op, res, seq[j],
                                                 blocks)))
                i = j + 1
                continue
        if impl == "cuda" and _attention_pair(seq, i):
            steps.append(((op, seq[i + 1]),
                          _attention_step(op, seq[i + 1])))
            i += 2
            continue
        if isinstance(op, Aggregate):
            steps.append(((op,), _step_aggregate(op, impl, blocks)))
        elif isinstance(op, Residual):
            steps.append(((op,), _step_residual(op)))
        elif isinstance(op, Transform):
            steps.append(((op,), _step_transform(op, impl, blocks)))
        elif isinstance(op, AttentionScore):
            steps.append(((op,), _step_attention_score(op)))
        elif isinstance(op, AttentionSoftmax):
            steps.append(((op,), _step_attention_softmax(op, impl)))
        else:
            raise TypeError(f"op {op!r} is not a layer op")
        i += 1
    return steps


def _compile_section(seq: Sequence[AckOp], impl: str,
                     blocks: BlockSpec = None):
    labeled = compile_steps(seq, impl, blocks)
    steps = [step for _, step in labeled]
    # the attention steps (scores, softmax and its tail) of a GAT layer:
    # the first and last step indices a traced run brackets with marks
    attn = [i for i, (ops, _) in enumerate(labeled)
            if isinstance(ops[0], (AttentionScore, AttentionSoftmax))]
    a0, a1 = (attn[0], attn[-1]) if attn else (-1, -1)
    # the sg Aggregate steps, each bracketed alone (gpu.aggregate)
    sg = {i for i, (ops, _) in enumerate(labeled)
          if len(ops) == 1 and isinstance(ops[0], Aggregate)
          and ops[0].mode == "sg"}

    def apply(p, h, batch, h0=None, mark=None):
        # "h0" is the propagation ENTRY state: the layer input for
        # layer0, the post-layer0 prediction (constant across the inner
        # layers) for inner layers — APPNP's teleport anchor
        regs = {"h": h, "h_in": h, "h0": h if h0 is None else h0}
        if mark is None:
            for s in steps:
                s(p, regs, batch)
            return regs["h"]
        for i, s in enumerate(steps):
            if i == a0:
                mark("attention.begin")
            if i in sg:
                mark("aggregate.begin")
            s(p, regs, batch)
            if i in sg:
                mark("aggregate.end")
            if i == a1:
                mark("attention.end")
        mark("layer")
        return regs["h"]
    return apply


def compile_program(prog: AckProgram, impl: str = "cuda",
                    blocks: BlockSpec = None):
    """Lower a specialized AckProgram once to ``run(params, batch,
    mark=None) -> (embeddings [C, f], final h [C, N, f])``: layer0, then
    the L-1 inner layers (one per index ``l`` of the stacked
    ``params["layers"]``), then the tail. A per-batch dispatch variant is
    one such callable. ``mark(label)``, where given, is called after each
    layer ("layer"), around a layer's attention steps ("attention.begin",
    "attention.end"), around each sg Aggregate ("aggregate.begin",
    "aggregate.end") and after the tail ("tail"): a traced batch's device
    spans (``obs.Tracer.gpu_marker``). It only records; what runs is the
    same."""
    if not prog.specialized:
        raise ValueError(
            "program has unspecialized mux ops — call specialize() first")
    apply0 = _compile_section(prog.layer0, impl, blocks)
    apply_i = _compile_section(prog.inner, impl, blocks) \
        if prog.n_layers > 1 else None

    def run(params, batch, mark=None):
        h = apply0(params["layer0"], batch["feats"], batch, mark=mark)
        if apply_i is not None:
            h0 = h                  # inner-entry prediction, teleport anchor
            layers = params["layers"]
            depth = {int(v.shape[0]) for v in layers.values()}
            if depth != {prog.n_layers - 1}:
                raise ValueError(f"params['layers'] stacks {sorted(depth)} "
                                 f"layers, the program runs "
                                 f"{prog.n_layers - 1}")
            for l in range(prog.n_layers - 1):
                h = apply_i({k: v[l] for k, v in layers.items()}, h, batch,
                            h0=h0, mark=mark)
        emb = h
        for op in prog.tail:
            if isinstance(op, Readout):
                emb = readout(h, batch["mask"], op.kind)
            elif isinstance(op, Classify):
                emb = emb @ params[op.w] + params[op.b]
            else:
                raise TypeError(f"op {op!r} is not a tail op")
        if mark is not None:
            mark("tail")
        return emb, h
    return run


def execute(prog: AckProgram, params, batch, impl: str = "cuda",
            blocks: BlockSpec = None, mark=None):
    """Run a specialized AckProgram (``compile_program`` then one call).
    Returns ``(embeddings [C, f], final h [C, N, f])``; ``blocks`` carries
    autotuned kernel block sizes (see ``compile_steps``), None keeps the
    kernels' defaults; ``mark`` as ``compile_program``'s ``run`` takes
    it."""
    return compile_program(prog, impl, blocks)(params, batch, mark=mark)


def lower_and_specialize(cfg, *, avg_edges: float = 0.0,
                         force: ForceSpec = None
                         ) -> Tuple[AckProgram, ProgramDecision]:
    """Convenience: lower ``cfg`` and specialize at its receptive field."""
    return specialize(lower(cfg), n=cfg.receptive_field,
                      avg_edges=avg_edges, f_in=cfg.f_in,
                      f_hidden=cfg.f_hidden, force=force)
