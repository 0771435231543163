"""Shared model building blocks: dense init, norms, activations, casts,
and the activation-sharding hook.

The PyTorch counterpart of ``repro.models.common``. Models are functional:
``init_*`` returns nested dicts of tensors, the apply functions are pure
apart from the decode cache (see ``attention.decode_attention``).
Activation sharding is annotated through ``shard()`` with *logical* axis
names; the mapping to mesh axes is installed by the launcher (see
``repro_torch.distributed.sharding.activation_rules``) and ``shard`` is the
identity otherwise, and on any tensor that is not a DTensor, so the same
model code runs on one card and in the dry-run over a fake mesh
(``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_tls = threading.local()


def _rules() -> Optional[dict]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def logical_axis_rules(rules: dict):
    """rules: logical axis name -> mesh axis (str, tuple, or None)."""
    old = _rules()
    _tls.rules = rules
    try:
        yield
    finally:
        _tls.rules = old


def logical_to_pspec(axes: Sequence[Optional[str]], rules=None) -> tuple:
    """A spec (a plain tuple, one entry a tensor dim: a mesh axis name, a
    tuple of them, or None) for the logical ``axes``."""
    rules = rules if rules is not None else (_rules() or {})
    return tuple(rules.get(a) if a is not None else None for a in axes)


def shard(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor ``x`` to the placements the logical ``axes``
    name on its mesh (the counterpart of ``with_sharding_constraint``);
    ``x`` itself when no rules are installed, when every axis maps to
    None, or when ``x`` is not a DTensor."""
    rules = _rules()
    if not rules or not is_dtensor(x):
        return x
    spec = logical_to_pspec(axes, rules)
    if all(s is None for s in spec):
        return x
    from repro_torch.distributed.sharding import placements
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate_dims(x, dims):
    """A DTensor ``x`` with the mesh dims that shard any of its tensor dims
    ``dims`` made ``Replicate`` (an all-gather), for an op DTensor has no
    strategy for on a sharded dim; ``x`` itself otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def fit_split(x, dim: int, first: int):
    """``x`` ready to have dim ``dim`` split into (``first``, rest): a
    DTensor whose shards of that dim would not split evenly (DTensor
    refuses an uneven unflatten, where GSPMD pads) gets the dim
    replicated; ``x`` itself otherwise."""
    if not is_dtensor(x):
        return x
    d = dim % x.dim()
    ways = 1
    for m, p in enumerate(x.placements):
        if p.is_shard() and p.dim == d:
            ways *= x.device_mesh.size(m)
    return x if first % ways == 0 else replicate_dims(x, [d])


def fit_merge(x, dim: int):
    """``x`` ready to have dim ``dim`` merged with the next: a DTensor
    sharded unevenly there gets the dim replicated (DTensor refuses an
    uneven flatten); ``x`` itself otherwise."""
    return fit_split(x, dim, x.shape[dim])


def masked_fill(x, mask, value):
    """``x.masked_fill_(mask, value)``, or its out-of-place twin for a
    DTensor (which refuses an in-place op that changes its placement);
    the same values either way."""
    if is_dtensor(x):
        return x.masked_fill(mask, value)
    return x.masked_fill_(mask, value)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``. With a DTensor operand it runs on the
    local shards instead, under placements chosen here, and the result is
    rewrapped: DTensor's own einsum strategy enumerates every placement of
    every operand dim, which on a mesh of three dims takes minutes an op.
    A mesh dim keeps one sharded letter: kept where both operands shard
    it alike, or where one operand shards a letter the other lacks; an
    operand that has the letter unsharded is sharded to match; the other
    operand's conflicting shard and any ``Partial`` or strided input are
    replicated. The result is ``Shard`` on that letter, or, where the
    letter is summed out, all-reduced to ``Replicate`` at once."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    return _on_shards(eq, a, b, lambda x, y: torch.einsum(eq, x, y))


def _gather_data_axes(a, w):
    """The weight ``w`` of ``a @ w`` with its FSDP shards (those on the
    data axes) gathered, as GSPMD does where the gather moves fewer bytes
    than the alternative: a shard of the summed dim is kept when ``a`` is
    whole on that axis and its partial product is smaller than the
    weight (decode's few tokens), and is all-reduced after the product."""
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    names = mesh.mesh_dim_names or ()
    a_pl = a.placements if is_dtensor(a) else [Replicate()] * mesh.ndim
    out_rows = a.numel() // a.shape[-1]
    want = []
    for m, (n, p) in enumerate(zip(names, w.placements)):
        keep = (n not in ("pod", "data") or not p.is_shard()
                or (p.dim == w.dim() - 2 and a_pl[m].is_replicate()
                    and out_rows * w.shape[-1] < w.numel()))
        want.append(p if keep else Replicate())
    return w if tuple(want) == tuple(w.placements) else w.redistribute(
        mesh, want)


def mm(a, b, out_dtype=None):
    """``torch.mm(a, b, out_dtype=out_dtype)``; with a DTensor operand on
    the local shards as ``einsum`` runs (DTensor has no strategy for
    ``mm`` with an ``out_dtype``)."""
    kw = {} if out_dtype is None else {"out_dtype": out_dtype}
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.mm(a, b, **kw)
    return _on_shards("md,dn->mn", a, b, lambda x, y: torch.mm(x, y, **kw))


def _on_shards(eq: str, a, b, op, keep_b: bool = False):
    """``op`` (the contraction ``eq``) on the local shards of ``a`` and
    ``b`` under the placements ``einsum`` documents, rewrapped; with
    ``keep_b`` a conflicting shard of ``a`` yields to ``b``'s instead."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lhs, out = eq.replace(" ", "").split("->")
    la, lb = lhs.split(",")
    mesh = (a if is_dtensor(a) else b).device_mesh
    if not is_dtensor(a):
        a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if not is_dtensor(b):
        b = DTensor.from_local(b, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    # a Partial or strided-shard input is gathered whole on its mesh dim
    rep = lambda p: p if type(p) is Shard else Replicate()  # noqa: E731
    pa, pb = [rep(p) for p in a.placements], [rep(p) for p in b.placements]
    out_pl = []
    for m in range(mesh.ndim):
        sa = la[pa[m].dim] if pa[m].is_shard() else None
        sb = lb[pb[m].dim] if pb[m].is_shard() else None
        if sa and sb and sa != sb:
            # the operand that shards a summed-out letter yields (a weight's
            # FSDP shard is gathered, an activation's hidden dim is
            # gathered); between two kept letters, ``keep_b`` says who wins
            if (sa in out) == (sb in out):
                a_yields = keep_b
            else:
                a_yields = sa not in out
            if a_yields:
                pa[m], sa = Replicate(), None
            else:
                pb[m], sb = Replicate(), None
        letter = sa or sb
        if letter is None:
            out_pl.append(Replicate())
            continue
        if letter in la:
            pa[m] = Shard(la.index(letter))
        if letter in lb:
            pb[m] = Shard(lb.index(letter))
        out_pl.append(Shard(out.index(letter)) if letter in out
                      else Partial())
    a = a.redistribute(mesh, pa)
    b = b.redistribute(mesh, pb)
    local = op(a.to_local(), b.to_local()).contiguous()
    size = dict(zip(la, a.shape))
    size.update(zip(lb, b.shape))
    shape = torch.Size(size[c] for c in out)
    stride = torch.empty(shape, device="meta").stride()
    y = DTensor.from_local(local, mesh, out_pl, run_check=False,
                           shape=shape, stride=stride)
    if any(p.is_partial() for p in out_pl):   # all-reduced at once, as
        y = y.redistribute(mesh, [rep(p) for p in out_pl])   # GSPMD does
    return y


def on_replicated(fn, *xs):
    """``fn(*xs)``. With DTensor arguments: each is gathered whole
    (``Replicate``), ``fn`` runs on the local tensors, and its tensor
    result comes back as a replicated DTensor on the first one's mesh, so
    autograd crosses the boundary in both directions (for index
    arithmetic DTensor has no strategy for)."""
    dts = [x for x in xs if is_dtensor(x)]
    if not dts:
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    local = [x.redistribute(mesh, rep).to_local() if is_dtensor(x) else x
             for x in xs]
    return DTensor.from_local(fn(*local), mesh, rep, run_check=False)


def roll_left(x):
    """``torch.roll(x, -1, dims=1)`` as two slices concatenated (DTensor
    has no strategy for ``roll`` in some torch releases); the same copy."""
    return torch.cat([x[:, 1:], x[:, :1]], dim=1)


def _along_local(x, d: int, fn):
    """``fn`` of a DTensor's local shard, rewrapped with its placements
    (a mesh dim that shards dim ``d`` gathered first): for a scan along
    ``d``."""
    from torch.distributed.tensor import DTensor
    x = replicate_dims(x, [d])
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


class _LocalCumsum(torch.autograd.Function):
    """A DTensor's cumulative sum and its backward (the reversed sum, as
    autograd's: flip, cumsum, flip) on local shards, each under its own
    tensor's placements."""

    @staticmethod
    def forward(ctx, x, d):
        ctx.d = d
        return _along_local(x, d, lambda t: torch.cumsum(t, d))

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        return _along_local(g, d, lambda t: t.flip(d).cumsum(d).flip(d)), None


def cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``. On a DTensor it runs on the local shards,
    forward and backward (``_LocalCumsum``): DTensor has no strategy for
    the ``aten.flip`` of cumsum's backward in some torch releases. The
    same local ops as DTensor's own, and no more collectives."""
    if not is_dtensor(x):
        return torch.cumsum(x, dim)
    return _LocalCumsum.apply(x, dim % x.dim())


def full_local(x):
    """A DTensor gathered whole on this rank as a plain tensor (for the
    index arithmetic DTensor has no strategy for); ``x`` itself
    otherwise."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# initializers


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where parameters are built on
    the ``meta`` device (shapes and types only, no memory): the inits read
    only its ``device``, and ``randn`` draws nothing from it."""
    device = torch.device("meta")


def randn(gen, shape):
    """Standard normals of ``shape`` from ``gen`` on its own device; on
    ``meta`` (a ``MetaGenerator``) an empty tensor of that shape."""
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen, shape, dtype=torch.float32):
    """LeCun-normal (fan-in = ``shape[-2]``) init for projection matrices,
    drawn from the ``torch.Generator`` ``gen`` on its own device."""
    fan_in = shape[-2]
    return randn(gen, shape).div_(math.sqrt(fan_in)).to(dtype)


def embed_init(gen, shape, dtype=torch.float32):
    return randn(gen, shape).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations


def rms_norm(x, scale, eps=1e-5):
    """Normalizes in fp32, casts back to x's type, then multiplies by
    ``scale`` (so a bf16 x with an fp32 scale gives fp32, as in JAX)."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale + bias


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# misc


def cast_tree(tree, dtype):
    """Every floating tensor of a nested dict cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def matmul(a, b):
    """``a @ b`` after promoting both to their common type, as ``jnp``'s
    ``@`` does (torch refuses mixed types). With a DTensor operand it runs
    on the local shards as ``einsum`` does, as GSPMD partitions a
    projection: ``b`` (the weight) gathered over the data axes (FSDP) and
    otherwise kept where its spec puts it, ``a`` moved to match. DTensor's
    own ``mm`` strategy is chosen by the bytes each redistribution would
    move, so it gathers a small weight whole."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if not (is_dtensor(a) or is_dtensor(b)):
        return a @ b
    if is_dtensor(b):
        b = _gather_data_axes(a, b)
    lead = "abcdefgh"[:a.dim() - 1]
    eq = (f"{lead}k,kn->{lead}n" if b.dim() == 2
          else f"{lead}k,{lead[:-1]}kn->{lead}n")
    return _on_shards(eq, a, b, lambda x, y: x @ y, keep_b=True)


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return tree.numel()
