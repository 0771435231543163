"""Per-device operation counts of an eager step, the counterpart of
``repro.launch.hlo_analysis`` (which walks compiled HLO text; this reads
the ops the step dispatches).

``counting()`` pushes a ``TorchDispatchMode`` and yields an ``OpSummary``
that fills while the step runs. Under DTensor the mode sees each op twice:
once at the DTensor level, at global shapes with the operands'
placements, which it hands on (``NotImplemented``), and then as the local
ops DTensor runs on this rank's shards, collectives included, which it
counts. So every number is a per-device quantity of rank 0, whether the
step runs on one card, on ``meta`` tensors, or on ``meta`` DTensors over
the fake process group of ``launch.mesh``. What DTensor runs to propagate
an op's output shape and placements is not counted: its fake tensors, and
every op dispatched inside its sharding propagator's shape propagation and
decomposition strategy (torch 2.11 registers no strategy for leaky_relu
and ELU, so DTensor traces their decompositions, ``gt``, ``mul``,
``where``, ``expm1``, on ``meta`` tensors at global shapes for each
candidate placement: counted, the GAT survey cell read 410 times its HBM
bytes).

Conventions:
  * FLOPs: ``torch.utils.flop_counter``'s formulas for the matmul-type ops
    (mm, bmm, addmm, baddbmm, convolution, SDPA; einsum and matmul reach
    the mode as those), 2·prod(result)·prod(contracted) as the reference
    counts a dot, summed over the local ops and by the type of their
    first operand (``flops_by_dtype``). Elementwise ops are not counted,
    as the reference counts no elementwise HLO op.
  * HBM bytes: the result and operand bytes of every local op, skipping
    views and metadata ops (the reference's ``_OPS_SKIP_BYTES``). Eager
    dispatch fuses nothing, so every op counts as a top-level op: the
    number is an upper bound of what a fused program moves.
  * Collective bytes: per ``_c10d_functional`` op, the result-buffer
    bytes with the reference's ring factors: all-gather, reduce-scatter
    and all-to-all move (g-1)/g of them across links, all-reduce twice
    that, a permute all of them. The group size g is the op's own group's.
  * Peak live bytes: the bytes of the tensors the step allocates that are
    alive at once, at most (freed through weak references), the
    counterpart of ``memory_analysis``'s temp bytes.
  * Hand kernels: a ``ctypes`` launch is invisible to the dispatcher, so
    each wrapper in ``kernels/`` reports its own operations and bytes
    through ``note_kernel`` (from its ``*_cost`` function) when a summary
    is active, and does nothing otherwise.

There are no while loops to correct: eager dispatch runs every iteration
of a loop, so the reference's ``n_while`` and ``trip_counts`` have no
counterpart.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# ring-cost factor of each collective kind (the reference's _COLL_FACTOR)
COLL_FACTOR = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# _c10d_functional op -> (collective kind, index of its group-size or
# group-name argument)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_reduce": ("all-reduce", 2),
    "all_to_all_single": ("all-to-all", 3),
    "broadcast": ("collective-permute", 2),
}

# ops that move no bytes of their own (metadata, allocation, bookkeeping)
_SKIP_BYTES = {aten.empty, aten.empty_strided, aten.empty_like,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.lift_fresh, aten._local_scalar_dense, aten.alias,
               aten.set_, aten.resize_, aten.is_same_size}

_SHAPE_OPS = {aten.sym_size, aten.sym_stride, aten.sym_numel,
              aten.sym_storage_offset, aten.is_contiguous, aten.size,
              aten.stride, aten.storage_offset, aten.numel, aten.dim,
              aten.is_strides_like_format, aten.is_non_overlapping_and_dense}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpSummary:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0            # raw result-buffer bytes
    collective_link_bytes: float = 0.0       # with ring (g-1)/g factors
    per_collective: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    # link bytes by the size of the group they cross (the roofline prices
    # a group of <= 8 cards on NVLink, a larger one on the network)
    link_bytes_by_group: Dict[str, float] = field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    kernels: Dict[str, dict] = field(default_factory=dict)
    live_bytes: int = 0
    peak_live_bytes: int = 0

    def add_flops(self, flops: float, dtype) -> None:
        key = str(dtype).replace("torch.", "")
        self.flops += flops
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + flops

    def to_json(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_link_bytes": self.collective_link_bytes,
            "per_collective": self.per_collective,
            "collective_count": self.collective_count,
            "link_bytes_by_group": self.link_bytes_by_group,
            "flops_by_dtype": self.flops_by_dtype,
            "kernels": self.kernels,
        }


class _Local(threading.local):
    """Per-thread state, its defaults class attributes: ``active()`` runs
    on every kernel launch, and a missing attribute of a plain
    ``threading.local`` is found only after a raised AttributeError."""
    summary = None
    propagating = 0


_tls = _Local()
_prop_lock = threading.Lock()
_prop_users = 0
_prop_undo: list = []


def active() -> "OpSummary | None":
    """The summary of the innermost ``counting()`` on this thread."""
    return _tls.summary


def note_kernel(name: str, flops, hbm_bytes: float, dtype=None) -> None:
    """Record one launch of hand kernel ``name`` in the active summary:
    its operations (of type ``dtype``, or ``{type: operations}`` for a
    kernel that mixes types) and the bytes it moves. Nothing without an
    active summary."""
    s = active()
    if s is None:
        return
    by_type = flops if isinstance(flops, dict) else {dtype: flops}
    for dt, f in by_type.items():
        s.add_flops(float(f), dt)
    s.hbm_bytes += float(hbm_bytes)
    k = s.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                    "hbm_bytes": 0.0})
    k["launches"] += 1
    k["flops"] += float(sum(by_type.values()))
    k["hbm_bytes"] += float(hbm_bytes)


def _group_size(kind_arg):
    if isinstance(kind_arg, int):
        return kind_arg
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(kind_arg).size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class _Counter(TorchDispatchMode):
    def __init__(self, summary: OpSummary, exits: contextlib.ExitStack):
        super().__init__()
        self.s = summary
        self.exits = exits               # closed after the mode is popped
        self.saw_dtensor = False

    def _track(self, t) -> None:
        n = _nbytes(t)
        s = self.s
        s.live_bytes += n
        s.peak_live_bytes = max(s.peak_live_bytes, s.live_bytes)

        def free(summary=s, n=n):
            summary.live_bytes -= n
        weakref.finalize(t, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if not self.saw_dtensor:     # plain counts never wrap torch's
                self.saw_dtensor = True  # propagation methods
                self.exits.enter_context(_uncounted_propagation())
            return NotImplemented        # count the local ops it runs
        if isinstance(func, torch._ops.HigherOrderOperator) or getattr(
                _tls, "propagating", 0):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _SHAPE_OPS:
            return func(*args, **kwargs)
        flat_in, _ = tree_flatten((args, kwargs))
        ins = [a for a in flat_in if isinstance(a, torch.Tensor)]
        if any(_is_fake(a) for a in ins):
            return func(*args, **kwargs)  # DTensor's shape propagation
        from torch.utils.flop_counter import flop_registry
        if packet not in flop_registry and func.namespace == "aten":
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        s = self.s
        if packet in flop_registry:
            s.add_flops(float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out)),
                        ins[0].dtype if ins else torch.float32)
        if func.namespace == "_c10d_functional":
            spec = _COLLECTIVES.get(packet.__name__)
            if spec is not None:
                kind, gi = spec
                b = sum(_nbytes(o) for o in outs)
                g = _group_size(args[gi])
                ring = COLL_FACTOR[kind] * b * max(g - 1, 0) / max(g, 1)
                s.collective_bytes += b
                s.collective_link_bytes += ring
                s.link_bytes_by_group[str(g)] = \
                    s.link_bytes_by_group.get(str(g), 0.0) + ring
                s.per_collective[kind] = s.per_collective.get(kind, 0.0) + b
                s.collective_count[kind] = \
                    s.collective_count.get(kind, 0) + 1
            return out
        if func.namespace != "aten" or func.is_view:
            return out
        if packet not in _SKIP_BYTES:
            s.hbm_bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(o) for o in outs)
        in_storages = {id_storage(t) for t in ins}
        for o in outs:                   # a new allocation, not a write
            if id_storage(o) not in in_storages:
                self._track(o)
        return out


def id_storage(t) -> int:
    return t.untyped_storage()._cdata


def _shape_propagation(real):
    """DTensor's shape propagation ``real``, marking this thread as
    propagating while it runs (the counter skips what it dispatches)."""
    def propagate(*args, **kwargs):
        _tls.propagating = getattr(_tls, "propagating", 0) + 1
        try:
            return real(*args, **kwargs)
        finally:
            _tls.propagating -= 1
    return propagate


def _propagation_methods():
    """(owner, method name) of each step by which DTensor derives an op's
    output shape and placements by running it on stand-ins: the sharding
    propagator's shape propagation (the op on fake tensors), and, for an
    op with no registered strategy, ``DecompShardingStrategy``'s trace of
    its decomposition on ``meta`` tensors at global shapes for each
    candidate placement (a staticmethod on torch 2.11, a method of the
    propagator's ``decomp_strategy`` on 2.13)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._decompositions import \
        DecompShardingStrategy
    return [(DTensor._op_dispatcher.sharding_propagator,
             "_propagate_tensor_meta_non_cached"),
            (DecompShardingStrategy, "propagate_strategy")]


def _wrap_method(owner, name):
    """``owner.name`` run through ``_shape_propagation``: on a class, its
    function or staticmethod replaced; on an instance, an attribute over
    the method. Returns what undoes it."""
    if isinstance(owner, type):
        raw = owner.__dict__[name]
        if isinstance(raw, staticmethod):
            setattr(owner, name,
                    staticmethod(_shape_propagation(raw.__func__)))
        else:
            setattr(owner, name, _shape_propagation(raw))
        return lambda: setattr(owner, name, raw)
    setattr(owner, name, _shape_propagation(getattr(owner, name)))
    return lambda: delattr(owner, name)


@contextlib.contextmanager
def _uncounted_propagation():
    """While any ``counting()`` block that has seen a DTensor op is open,
    the propagation methods run through ``_shape_propagation``, so the
    counter skips what they dispatch. A count of plain tensors never
    enters it."""
    global _prop_users, _prop_undo
    with _prop_lock:
        if _prop_users == 0:
            _prop_undo = [_wrap_method(o, n)
                          for o, n in _propagation_methods()]
        _prop_users += 1
    try:
        yield
    finally:
        with _prop_lock:
            _prop_users -= 1
            if _prop_users == 0:
                for undo in _prop_undo:
                    undo()
                _prop_undo = []


@contextlib.contextmanager
def counting():
    """Count the ops dispatched inside the block; yields the
    ``OpSummary``, complete when the block ends. Nests: an inner block
    has its own summary."""
    summary = OpSummary()
    old = active()
    _tls.summary = summary
    try:
        with contextlib.ExitStack() as exits, _Counter(summary, exits):
            yield summary
    finally:
        _tls.summary = old


def local_bytes(tree) -> int:
    """Bytes of the tensors of a nested tree on this rank: a DTensor's
    local shard, a plain tensor whole (``meta`` ones too)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            n += _nbytes(t)
    return n


def storages(tree) -> set:
    """The storage ids of a tree's local tensors."""
    from torch.distributed.tensor import DTensor
    out = set()
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            out.add(id_storage(t))
    return out


__all__ = ["COLL_FACTOR", "OpSummary", "active", "counting", "local_bytes",
           "note_kernel", "storages"]
