"""Versioned wire codec for host<->host payloads (no pickle).

The PyTorch package's copy of ``repro.distributed.wire`` (numpy only),
with the same ``MAGIC`` and ``WIRE_VERSION``: the format is shared, so a
device host of either package talks to a graph host of either, and the
same plan encodes to the same bytes in both.

Everything that crosses a transport — RPC requests, per-target node
lists, built ``SubgraphRows``, full ``BatchPlan`` payloads including the
store's per-shard slot lists and generation pins — is a tree of plain
JSON values plus numpy arrays. The frame layout keeps the two worlds
separate so decode is exact and bounded:

    MAGIC "ACKW" | u16 version | u64 frame length      (14-byte header)
    u32 meta length | meta JSON                        (structure)
    raw array buffers, concatenated                    (data)

The meta JSON mirrors the tree; every ndarray is replaced by a
placeholder recording its exact ``dtype.str`` (endianness included),
shape (0-d scalars round-trip as 0-d), and (offset, nbytes) into the
buffer section. Decoding is ``np.frombuffer`` + reshape — bitwise
identical to what was encoded, which is what lets the loopback transport
prove the remote pipeline equals the in-process one.

Version mismatches and truncated/corrupt frames raise typed errors with
actionable messages (``WireVersionError`` / ``WireFormatError``) instead
of garbage arrays.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

MAGIC = b"ACKW"
WIRE_VERSION = 1

_HEADER = struct.Struct(">4sHQ")          # magic, version, frame length
_META_LEN = struct.Struct(">I")

_ND = "__nd__"                            # ndarray placeholder key
_BYTES = "__bytes__"                      # raw-bytes placeholder key
_RESERVED = (_ND, _BYTES)


class WireError(ValueError):
    """Base class for wire codec failures."""


class WireFormatError(WireError):
    """Frame is not a well-formed ACK wire frame (bad magic, truncation,
    out-of-bounds buffer reference, unencodable value)."""


class WireVersionError(WireError):
    """Frame was produced by an incompatible codec version."""


# -- generic tree codec ------------------------------------------------------

def encode(tree: Any) -> bytes:
    """Encode a JSON+ndarray tree into one self-describing frame."""
    buffers: List[bytes] = []
    offset = 0

    def enc(node):
        nonlocal offset
        if isinstance(node, np.ndarray):
            # record the ORIGINAL shape: ascontiguousarray promotes 0-d
            # scalars (store_gen/shard_gen pins) to 1-d on some numpys
            raw = np.ascontiguousarray(node).tobytes()
            ph = {_ND: [node.dtype.str, list(node.shape), offset,
                        len(raw)]}
            buffers.append(raw)
            offset += len(raw)
            return ph
        if isinstance(node, (bytes, bytearray, memoryview)):
            raw = bytes(node)
            ph = {_BYTES: [offset, len(raw)]}
            buffers.append(raw)
            offset += len(raw)
            return ph
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if not isinstance(k, str):
                    k = str(k)           # payload dicts may key by int id
                if k in _RESERVED:
                    raise WireFormatError(
                        f"dict key {k!r} is reserved by the wire codec")
                out[k] = enc(v)
            return out
        if isinstance(node, (list, tuple)):
            return [enc(v) for v in node]
        if isinstance(node, (np.integer,)):
            return int(node)
        if isinstance(node, (np.floating,)):
            return float(node)
        if isinstance(node, (np.bool_,)):
            return bool(node)
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        raise WireFormatError(
            f"cannot encode {type(node).__name__} on the wire; "
            "allowed: None/bool/int/float/str/bytes, numpy arrays, "
            "and lists/dicts of those")

    meta = json.dumps(enc(tree), separators=(",", ":")).encode("utf-8")
    body = b"".join(buffers)
    frame_len = _HEADER.size + _META_LEN.size + len(meta) + len(body)
    return b"".join([_HEADER.pack(MAGIC, WIRE_VERSION, frame_len),
                     _META_LEN.pack(len(meta)), meta, body])


def frame_length(header: bytes) -> int:
    """Total frame length declared by a 14-byte header (transports read
    the header first, then exactly the rest). Validates magic+version."""
    if len(header) < _HEADER.size:
        raise WireFormatError(
            f"short header: got {len(header)} bytes, "
            f"need {_HEADER.size}")
    magic, version, length = _HEADER.unpack_from(header)
    if magic != MAGIC:
        raise WireFormatError(
            f"bad magic {magic!r}: not an ACK wire frame "
            f"(expected {MAGIC!r})")
    if version != WIRE_VERSION:
        raise WireVersionError(
            f"wire version mismatch: peer sent v{version}, this process "
            f"speaks v{WIRE_VERSION} — upgrade the older side so device "
            "host and graph hosts run the same repro version")
    return int(length)


def decode(frame: bytes) -> Any:
    """Decode one frame back into the original tree (arrays bitwise)."""
    declared = frame_length(frame)       # validates magic + version
    if len(frame) < declared:
        raise WireFormatError(
            f"frame truncated: header declares {declared} bytes, "
            f"got {len(frame)}")
    pos = _HEADER.size
    (meta_len,) = _META_LEN.unpack_from(frame, pos)
    pos += _META_LEN.size
    if pos + meta_len > len(frame):
        raise WireFormatError(
            f"frame truncated inside meta section: need {meta_len} "
            f"meta bytes at offset {pos}, frame is {len(frame)}")
    try:
        meta = json.loads(frame[pos:pos + meta_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"corrupt meta section: {e}") from e
    body_off = pos + meta_len
    body_len = len(frame) - body_off

    def dec(node):
        if isinstance(node, dict):
            if set(node) == {_ND}:
                dt, shape, off, nbytes = node[_ND]
                if off < 0 or off + nbytes > body_len:
                    raise WireFormatError(
                        f"array buffer [{off}, {off + nbytes}) outside "
                        f"body of {body_len} bytes (corrupt frame)")
                dtype = np.dtype(dt)
                count = nbytes // dtype.itemsize if dtype.itemsize else 0
                a = np.frombuffer(frame, dtype=dtype, count=count,
                                  offset=body_off + off)
                return a.reshape(shape)
            if set(node) == {_BYTES}:
                off, nbytes = node[_BYTES]
                if off < 0 or off + nbytes > body_len:
                    raise WireFormatError(
                        f"bytes buffer [{off}, {off + nbytes}) outside "
                        f"body of {body_len} bytes (corrupt frame)")
                return frame[body_off + off:body_off + off + nbytes]
            return {k: dec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [dec(v) for v in node]
        return node

    return dec(meta)


# -- domain helpers ----------------------------------------------------------

def node_lists_to_wire(node_lists: Sequence[np.ndarray]) -> dict:
    """Var-length per-target node lists -> one concat array + offsets."""
    lists = [np.asarray(nl, dtype=np.int64) for nl in node_lists]
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    if lists:
        offsets[1:] = np.cumsum([len(nl) for nl in lists])
        data = np.concatenate(lists) if offsets[-1] else \
            np.empty(0, np.int64)
    else:
        data = np.empty(0, np.int64)
    return {"data": data, "offsets": offsets}


def node_lists_from_wire(d: dict) -> List[np.ndarray]:
    data, offsets = np.asarray(d["data"]), np.asarray(d["offsets"])
    return [data[offsets[i]:offsets[i + 1]]
            for i in range(len(offsets) - 1)]


_ROW_FIELDS = ("adj", "adj_mean", "mask", "edge_src", "edge_dst",
               "edge_w", "self_w", "edge_w_mean")
_ROW_SCALARS = ("n_vertices", "n_edges", "edges_dropped")
_EDGE_FIELDS = ("edge_src", "edge_dst", "edge_w", "edge_w_mean")


def rows_to_wire(rows: Sequence, e_pad: Optional[int] = None) -> dict:
    """Stack C per-target ``SubgraphRows`` into [C, ...] arrays (fixed
    shapes — the decoupling property — make the stack exact). Each row's
    edge arrays take ``e_pad`` slots (the deployment's fixed layout, which
    both packages' hosts ship), or the longest row's where that is more."""
    from repro_torch.core.subgraph import edge_layout
    slots = max([int(e_pad or 0)] + [r.n_edges for r in rows])
    edges = dict(zip(_EDGE_FIELDS, edge_layout(
        rows, rows[0].adj.shape[0], slots)))
    d: Dict[str, np.ndarray] = {
        f: edges[f] if f in edges else np.stack([getattr(r, f)
                                                 for r in rows])
        for f in _ROW_FIELDS}
    for f in _ROW_SCALARS:
        d[f] = np.asarray([getattr(r, f) for r in rows], dtype=np.int64)
    return d


def rows_from_wire(d: dict) -> List:
    """The rows of ``rows_to_wire``, each edge array at its real edge
    count (as Build makes them). A row that a graph host cut
    (``edges_dropped`` > 0: a reference host's budget) is refused, as Build
    refuses a subgraph over its budget: ``EdgeBudgetError``, counted in
    ``core.subgraph.edges_refused`` and ``subgraphs_refused``."""
    from repro_torch.core.subgraph import SubgraphRows, check_edge_budget
    c = d["adj"].shape[0]
    out = []
    for i in range(c):
        e = int(d["n_edges"][i])
        check_edge_budget(e + int(d["edges_dropped"][i]), e)
        kw = {f: np.ascontiguousarray(d[f][i][:e] if f in _EDGE_FIELDS
                                      else d[f][i]) for f in _ROW_FIELDS}
        kw.update({f: int(d[f][i]) for f in _ROW_SCALARS})
        out.append(SubgraphRows(**kw).freeze())
    return out


def plan_to_wire(plan) -> dict:
    """BatchPlan -> wire tree: everything downstream stages read (Pack
    reads targets/node_lists/rows + the cache counters; the device side
    reads ``device``, whose store payload carries its generation pin —
    ``store_gen``/``shard_gen`` ride along bitwise, so residency pinning
    survives the hop). Frontiers ride along for cache-exact invalidation
    on whichever host holds the caches."""
    d: Dict[str, Any] = {
        "targets": np.asarray(plan.targets, dtype=np.int64),
        "nbr_hits": int(plan.nbr_hits),
        "nbr_misses": int(plan.nbr_misses),
        "build_hits": int(plan.build_hits),
        "build_misses": int(plan.build_misses),
        "row_gen": None if plan.row_gen is None else int(plan.row_gen),
    }
    if plan.node_lists is not None:
        d["node_lists"] = node_lists_to_wire(plan.node_lists)
    if plan.frontiers:
        keys = [int(t) for t, fr in plan.frontiers.items()
                if fr is not None]
        d["frontiers"] = {
            "targets": np.asarray(keys, dtype=np.int64),
            **node_lists_to_wire([plan.frontiers[t] for t in keys])}
    if plan.rows is not None:
        d["rows"] = rows_to_wire(plan.rows, plan.e_pad)
    if plan.device is not None:
        d["device"] = {k: np.asarray(v) for k, v in plan.device.items()}
    return d


def plan_from_wire(d: dict):
    from repro_torch.core.batchplan import BatchPlan
    plan = BatchPlan(targets=np.asarray(d["targets"]))
    plan.nbr_hits = int(d["nbr_hits"])
    plan.nbr_misses = int(d["nbr_misses"])
    plan.build_hits = int(d["build_hits"])
    plan.build_misses = int(d["build_misses"])
    plan.row_gen = d.get("row_gen")
    if "node_lists" in d:
        plan.node_lists = node_lists_from_wire(d["node_lists"])
    if "frontiers" in d:
        fr = d["frontiers"]
        fronts = node_lists_from_wire(fr)
        plan.frontiers = {int(t): f for t, f
                          in zip(np.asarray(fr["targets"]), fronts)}
    if "rows" in d:
        plan.rows = rows_from_wire(d["rows"])
    if "device" in d:
        plan.device = dict(d["device"])
    return plan


def payload_nbytes(tree: Any) -> int:
    """Total array bytes in a tree (transfer accounting helper)."""
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(payload_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(payload_nbytes(v) for v in tree)
    return 0


__all__ = ["MAGIC", "WIRE_VERSION", "WireError", "WireFormatError",
           "WireVersionError", "encode", "decode", "frame_length",
           "node_lists_to_wire", "node_lists_from_wire",
           "rows_to_wire", "rows_from_wire",
           "plan_to_wire", "plan_from_wire", "payload_nbytes"]
