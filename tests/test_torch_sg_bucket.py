"""The scatter-gather's ``bucket`` variant with an output row count of the
caller's (``n_out``) and its split sort, on the CPU, where the kernel
cannot run.

(a) The plain version with ``n_out`` against the reference's chunk
    Aggregate: ``repro.gnn.layers.agg_sg(..., n)`` and
    ``repro.precompute.propagate._agg_chunk_fn(n)`` (``segment_sum`` with
    ``num_segments=n``), with destinations at and past n_out, negative
    ones, weight-0 edges from inf/NaN rows; the wrapper takes the plain
    version for CPU tensors.
(b) ``chunk_aggregate`` with ``n_out`` (what the offline build now runs)
    against the compact form's first ``chunk`` rows without it, bitwise,
    NaN in the same places.
(c) A numpy model of the kernel's count -> scan -> stable placement over
    tiles of ``BUCKET_TILE`` edge slots (as ``csrc/scatter_gather.cu``'s
    ``bucket_count_kernel``, ``bucket_scan_kernel`` and
    ``bucket_place_kernel`` do it): every bucket holds its destination's
    live edges in edge order, with hub destinations whose edges span many
    tiles, a tile with no live edge and E not a multiple of the tile; the
    weight-0 marks ORed over all tiles give NaN exactly where 0 * h[src]
    is non-finite; and the sums taken from the model's buckets in float32,
    one rounding a product and a sum, agree with the reference. Each
    planted fault of the placement (a tile's cursors swapped with its
    neighbour's, the last tile dropped, marks from one tile only) breaks
    the model's invariants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.gnn.layers import agg_sg  # noqa: E402
from repro.precompute.propagate import _agg_chunk_fn  # noqa: E402
from repro_torch.kernels import scatter_gather as sg  # noqa: E402
from repro_torch.precompute.propagate import (_LocalCSR,  # noqa: E402
                                              chunk_aggregate, compact_chunk)
from repro_torch.graphs.synthetic import get_graph  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_kernels.py's fp32 tolerance


def _edges(rng, C, N, n_out, E, hub=None):
    """src in [0, N); dst mostly in [0, n_out), every 7th in [0, N) (some
    past n_out), every 13th negative or past N; every 5th weight 0; where
    ``hub`` is given, that many edges of subgraph 0 point at vertex 3."""
    src = rng.integers(0, N, (C, E)).astype(np.int32)
    dst = rng.integers(0, n_out, (C, E)).astype(np.int32)
    dst[:, ::7] = rng.integers(0, N, dst[:, ::7].shape)
    dst[:, 2::13] = np.where(rng.random(dst[:, 2::13].shape) < 0.5, -1, N + 2)
    w = rng.standard_normal((C, E)).astype(np.float32)
    w[:, ::5] = 0.0
    if hub:
        idx = rng.choice(E, hub, replace=False)
        dst[0, idx] = 3
        w[0, idx] = 2.0 + rng.random(hub).astype(np.float32)
    return src, dst, w


def _nonfinite_zero_sources(h, src, dst, w, n_out):
    """inf and NaN in two columns of the sources of weight-0 edges into
    the first n_out rows of subgraph 0."""
    zero = (w[0] == 0) & (dst[0] >= 0) & (dst[0] < n_out)
    s = src[0, zero]
    h[0, s[0], 1] = np.inf
    h[0, s[1], h.shape[2] - 1] = np.nan


def _held(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


# -- (a) the plain version with n_out against the reference -----------------


@pytest.mark.parametrize("C,N,n_out,E,F", [(1, 300, 64, 900, 12),
                                           (3, 120, 120, 700, 5),
                                           (2, 200, 1, 400, 7)])
def test_plain_with_n_out_matches_agg_sg(C, N, n_out, E, F):
    rng = np.random.default_rng(N + n_out)
    src, dst, w = _edges(rng, C, N, n_out, E)
    h = rng.standard_normal((C, N, F)).astype(np.float32)
    _nonfinite_zero_sources(h, src, dst, w, n_out)
    want = np.asarray(agg_sg(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(w), jnp.asarray(h), n_out))
    t = [torch.from_numpy(a) for a in (src, dst, w, h)]
    got = sg.scatter_gather_aggregate_ref(*t, n_out=n_out)
    assert tuple(got.shape) == (C, n_out, F)
    assert np.isnan(want).any()
    _held(got, want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(torch.nan_to_num(sg.scatter_gather_aggregate(
        *t, n_out=n_out)), torch.nan_to_num(got))


def test_plain_with_n_out_matches_the_reference_chunk_function():
    """The reference's jitted chunk Aggregate (C=1, 1-d edges, num_segments
    = the chunk's rows) on the full register."""
    rng = np.random.default_rng(3)
    N, n_out, E, F = 500, 48, 1500, 9
    src, dst, w = _edges(rng, 1, N, n_out, E, hub=300)
    h = rng.standard_normal((1, N, F)).astype(np.float32)
    _nonfinite_zero_sources(h, src, dst, w, n_out)
    want = np.asarray(_agg_chunk_fn(n_out)(src[0], dst[0], w[0], h[0]))
    got = sg.scatter_gather_aggregate_ref(
        *[torch.from_numpy(a) for a in (src, dst, w, h)], n_out=n_out)[0]
    _held(got, want)


def test_sources_out_of_range_are_skipped():
    """A source outside [0, N) adds nothing (the kernels skip the edge);
    the rest of the sum is the one without it."""
    rng = np.random.default_rng(5)
    N, E, F = 40, 200, 6
    src, dst, w = _edges(rng, 2, N, N, E)
    h = rng.standard_normal((2, N, F)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (src, dst, w, h)]
    bad = src.copy()
    bad[:, 1::9] = N + 3
    bad[:, 4::9] = -2
    keep = w.copy()
    keep[:, 1::9] = keep[:, 4::9] = 0.0
    got = sg.scatter_gather_aggregate_ref(torch.from_numpy(bad), t[1],
                                          t[2], t[3])
    want = sg.scatter_gather_aggregate_ref(t[0], t[1],
                                           torch.from_numpy(keep), t[3])
    torch.testing.assert_close(got, want, **TOL)


def test_n_out_bounds_and_cost():
    src = torch.zeros(1, 4, dtype=torch.int32)
    w = torch.ones(1, 4)
    h = torch.ones(1, 10, 8)
    with pytest.raises(ValueError, match="n_out"):
        sg.scatter_gather_aggregate(src, src, w, h, n_out=11)
    with pytest.raises(ValueError, match="n_out"):
        sg.scatter_gather_aggregate(src, src, w, h, n_out=-1)
    assert tuple(sg.scatter_gather_aggregate(src, src, w, h,
                                             n_out=0).shape) == (1, 0, 8)
    c, c_all = sg.sg_cost(src, src, w, h, 3), sg.sg_cost(src, src, w, h)
    assert c_all["hbm_bytes"] - c["hbm_bytes"] == 4 * 7 * 8
    assert c["flops"] == c_all["flops"] == 2 * 4 * 8


def test_offline_chunk_bound():
    """The offline build's largest chunk (C=1, 2048 of 32,868 source rows,
    62,080 edge slots): with n_out the bound is 0.0211 ms at F=500 and
    0.0109 ms at F=256 on an H100's 3.35 TB/s (0.0395 / 0.0203 with all
    N rows written)."""
    E, N, n = 62080, 32868, 2048
    src = torch.zeros(1, E, dtype=torch.int32)
    w = torch.ones(1, E)
    for f, want, want_all in ((500, 0.0211, 0.0395), (256, 0.0109, 0.0203)):
        h = torch.empty(1, N, f)
        ms = sg.sg_cost(src, src, w, h, n)["hbm_bytes"] / 3.35e12 * 1e3
        ms_all = sg.sg_cost(src, src, w, h)["hbm_bytes"] / 3.35e12 * 1e3
        assert round(ms, 4) == want and round(ms_all, 4) == want_all


# -- (b) the offline build's chunk with n_out ------------------------------


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("norm", ["gcn", "mean"])
def test_chunk_with_n_out_equals_the_compact_forms_first_rows(impl, norm):
    """Every chunk of a compute set: ``chunk_aggregate`` with n_out = the
    chunk against the compact form without it cut to the chunk's rows,
    bitwise, NaN in the same places (a non-finite row 0, the padding
    edges' source)."""
    g = get_graph("flickr", scale=0.01, seed=0)
    local = _LocalCSR(g, np.arange(g.num_vertices), 64, impl,
                      torch.device("cpu"))
    H = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (g.num_vertices, 10)).astype(np.float32))
    H[0, 2] = float("inf")
    H[0, 9] = float("nan")
    padded = 0
    for i, (rows, src, dst, nrows) in enumerate(local._chunks):
        h = torch.zeros(1, nrows, 10)
        h[0, :len(rows)] = H.index_select(0, rows)
        w = local._weights(norm)[i]
        got = chunk_aggregate(src, dst, w, h, impl, n_out=local.chunk)
        was = chunk_aggregate(src, dst, w, h, impl)[:, :local.chunk]
        assert tuple(got.shape) == (1, local.chunk, 10)
        assert torch.equal(torch.isnan(got), torch.isnan(was))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(was))
        padded += bool(torch.isnan(got).any())
    assert padded                      # the padding's 0 * inf showed


def test_compact_chunk_unchanged():
    """compact_chunk still returns N = max(chunk, sources) and row 0 where
    there is padding."""
    rows, csrc, cdst, n = compact_chunk(np.array([5, 9, 5], np.int32),
                                        np.array([0, 1, 1], np.int32), 8, 4)
    assert list(rows) == [0, 5, 9] and n == 4
    assert list(csrc) == [1, 2, 1, 0, 0, 0, 0, 0]
    assert list(cdst) == [0, 1, 1, 0, 0, 0, 0, 0]


# -- (c) a numpy model of the split sort -------------------------------------


def bucket_model(src, dst, w, N, n_out, tile, fault=None):
    """One subgraph through the kernel's count -> scan -> place: per tile,
    live edges (w != 0, src in [0, N), dst in [0, n_out)) counted by
    destination and weight-0 sources marked; an exclusive scan over
    (destination, tile), destination-major, giving each bucket's start
    and each tile's offset in it; per tile a stable sort by destination
    (dead slots keyed n_out), each live edge at start + offset + its rank
    in the tile's run. Returns (start [n_out + 1], pairs [live] of edge
    indices, the sources marked on any tile)."""
    E = len(src)
    T = max(1, -(-E // tile))
    inr = (src >= 0) & (src < N) & (dst >= 0) & (dst < n_out)
    live = inr & (w != 0)
    cnt = np.zeros((T, n_out), np.int64)
    marks = np.zeros((T, N), bool)
    tiles = range(T - 1) if fault == "last tile dropped" else range(T)
    for t in tiles:
        sl = slice(t * tile, (t + 1) * tile)
        np.add.at(cnt[t], dst[sl][live[sl]], 1)
        marks[t, src[sl][inr[sl] & (w[sl] == 0)]] = True
    total = cnt.sum(0)
    start = np.concatenate([[0], np.cumsum(total)])
    offset = np.cumsum(cnt, axis=0) - cnt          # over tiles, per bucket
    if fault == "cursors swapped" and T > 1:
        offset[[0, 1]] = offset[[1, 0]]
    pairs = np.full(start[-1], -1, np.int64)
    for t in tiles:
        e0 = t * tile
        key = np.where(live[e0:e0 + tile], dst[e0:e0 + tile], n_out)
        order = np.argsort(key, kind="stable")
        skey = key[order]
        for p, (k, e) in enumerate(zip(skey, order)):
            if k == n_out:
                break
            first = np.searchsorted(skey, k)
            pos = start[k] + offset[t, k] + (p - first)
            if 0 <= pos < len(pairs):
                pairs[pos] = e0 + e
    marked = marks[:1].any(0) if fault == "marks of tile 0" else marks.any(0)
    return start, pairs, marked


def _model_case(seed, N, n_out, E, tile, hub):
    """Edges sorted by destination (as the offline build's chunks are),
    a hub spanning many tiles, a run of dead slots covering one whole
    tile, and 37 slots of weight-0 padding at the end (inside the last
    tile) pointing at row 0."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n_out, E)).astype(np.int32)
    dst[rng.choice(E, hub, replace=False)] = 5
    dst = np.sort(dst)
    src = rng.integers(0, N, E).astype(np.int32)
    w = rng.standard_normal(E).astype(np.float32)
    w[w == 0] = 1.0
    d0 = int(np.searchsorted(dst, 5, side="right")) + 3
    w[d0:d0 + 2 * tile] = 0.0             # a whole tile with no live edge
    dst[-37:] = 0                         # the padding: row 0 -> 0, weight 0
    src[-37:] = 0
    w[-37:] = 0.0
    return src, dst, w


@pytest.mark.parametrize("N,n_out,E,hub", [(3000, 128, 9 * 512 + 77, 2500),
                                           (800, 800, 7 * 512 + 300, 1700),
                                           (900, 64, 512 * 12 - 1, 1800)])
def test_model_buckets_hold_edge_order(N, n_out, E, hub):
    tile = 512
    src, dst, w = _model_case(E, N, n_out, E, tile, hub)
    T = -(-E // tile)
    assert E % tile and T > 4
    live = (w != 0) & (dst < n_out)
    assert any(not live[t * tile:(t + 1) * tile].any() for t in range(T))
    hub_e = np.flatnonzero(live & (dst == 5))
    assert len(set(hub_e // tile)) > 3    # the hub spans many tiles
    start, pairs, marked = bucket_model(src, dst, w, N, n_out, tile)
    for d in range(n_out):
        np.testing.assert_array_equal(pairs[start[d]:start[d + 1]],
                                      np.flatnonzero(live & (dst == d)))
    np.testing.assert_array_equal(
        marked, np.isin(np.arange(N), src[(w == 0) & (dst < n_out)]))


def test_model_sums_match_the_reference():
    """The model's buckets summed in float32 in bucket order (one rounding
    a product, one a sum, as __fadd_rn(acc, __fmul_rn(h, w))) with NaN
    where a weight-0 edge's source is non-finite in a column, against
    ``agg_sg`` and the plain version."""
    tile, N, n_out, E, F = 512, 2000, 96, 512 * 7 + 45, 6
    src, dst, w = _model_case(1, N, n_out, E, tile, 900)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((N, F)).astype(np.float32)
    h[0, 2], h[0, 4] = np.inf, np.nan          # the padding's source row
    start, pairs, marked = bucket_model(src, dst, w, N, n_out, tile)
    out = np.zeros((n_out, F), np.float32)
    for d in range(n_out):
        for e in pairs[start[d]:start[d + 1]]:
            out[d] = out[d] + h[src[e]] * w[e]
    zero = (w == 0) & (dst < n_out)
    bad = ~np.isfinite(h) & marked[:, None]
    for s, d in zip(src[zero], dst[zero]):
        out[d][bad[s]] = np.nan
    want = np.asarray(agg_sg(jnp.asarray(src[None]), jnp.asarray(dst[None]),
                             jnp.asarray(w[None]), jnp.asarray(h[None]),
                             n_out))[0]
    assert np.isnan(out).any()
    _held(out, want)
    plain = sg.scatter_gather_aggregate_ref(
        *[torch.from_numpy(a[None]) for a in (src, dst, w, h)], n_out=n_out)
    _held(plain[0], out)


@pytest.mark.parametrize("fault", ["cursors swapped", "last tile dropped",
                                   "marks of tile 0"])
def test_model_faults_break_the_invariants(fault):
    """Each fault planted in the model (as ``scripts/gnn_fault_check.py``
    plants it in the kernel) breaks a bucket's edge order or the marks."""
    tile, N, n_out, E = 512, 1500, 80, 512 * 9 + 100
    src, dst, w = _model_case(4, N, n_out, E, tile, 1500)
    # tiles 0 and 1 share destinations (the edges are sorted by dst)
    assert set(dst[:tile]) & set(dst[tile:2 * tile])
    start, pairs, marked = bucket_model(src, dst, w, N, n_out, tile, fault)
    live = (w != 0) & (dst < n_out)
    buckets_ok = all(np.array_equal(pairs[start[d]:start[d + 1]],
                                    np.flatnonzero(live & (dst == d)))
                     for d in range(n_out))
    marks_ok = np.array_equal(
        marked, np.isin(np.arange(N), src[(w == 0) & (dst < n_out)]))
    assert not (buckets_ok and marks_ok)
