"""GAT's sparse-mode softmax under impl="cuda", whose segment sums (the
denominator and the numerator, in one call) go through the scatter-gather
kernel with the (subgraph, head) pairs on its batch axis so that the card
sums every
destination's edges in one order. On the CPU the kernel's plain version
runs; here it is held against the plain impl="torch" step (index_add_) at
the fp32 kernel tolerance of tests/test_kernels.py (2e-5) on the edges a
batch can have: a vertex with no in-edges beyond its self loop, a
subgraph whose edge slots are all padding, and one vertex with 64
in-edges; NaN lands where the plain step puts it (weight-0 padding edges
from a source row holding inf or NaN). The whole gat/sg program against
the reference's Pallas program is tests/test_torch_program.py's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import program as tprog  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
C, N, HEADS, FH, E = 3, 24, 2, 8, 96


def _batch(seed=0):
    """Subgraph 0: random live edges with vertex 5 given no in-edges;
    subgraph 1: every slot padding (weight 0); subgraph 2: 64 edges into
    vertex 7 and the rest padding. Padding slots point at N - 1."""
    rng = np.random.default_rng(seed)
    src = np.full((C, E), N - 1, np.int32)
    dst = np.full((C, E), N - 1, np.int32)
    w = np.zeros((C, E), np.float32)
    live = 60
    src[0, :live] = rng.integers(0, N - 1, live)
    dst[0, :live] = rng.choice([v for v in range(N - 1) if v != 5], live)
    w[0, :live] = rng.uniform(0.1, 1.0, live)
    src[2, :64] = rng.integers(0, N - 1, 64)
    dst[2, :64] = 7
    w[2, :64] = rng.uniform(0.1, 1.0, 64)
    regs = {"z": torch.from_numpy(
        rng.standard_normal((C, N, HEADS * FH)).astype(np.float32)),
        "s_src": torch.from_numpy(
            rng.standard_normal((C, N, HEADS)).astype(np.float32)),
        "s_dst": torch.from_numpy(
            rng.standard_normal((C, N, HEADS)).astype(np.float32))}
    batch = {"edge_src": torch.from_numpy(src),
             "edge_dst": torch.from_numpy(dst),
             "edge_w": torch.from_numpy(w),
             "mask": torch.ones(C, N)}
    params = {"b": torch.from_numpy(
        rng.standard_normal(HEADS * FH).astype(np.float32))}
    return params, regs, batch


def _run(impl, params, regs, batch):
    op = tprog.AttentionSoftmax(n_heads=HEADS, mode="sg")
    step = tprog._step_attention_softmax(op, impl)
    r = dict(regs)
    step(params, r, batch)
    return r["h"]


def test_sg_softmax_cuda_matches_plain_on_edge_cases():
    params, regs, batch = _batch()
    ops.reset_launch_counts()
    got = _run("cuda", params, regs, batch)
    want = _run("torch", params, regs, batch)
    # the CPU runs the scatter-gather's plain version: no kernel launch
    assert ops.launch_counts()["scatter_gather_aggregate"] == 0
    torch.testing.assert_close(got, want, **TOL)
    # vertex 5 of subgraph 0 attends to itself only: elu(z[5] + b)
    torch.testing.assert_close(
        got[0, 5], torch.nn.functional.elu(regs["z"][0, 5] + params["b"]),
        **TOL)
    # all padding: every vertex attends to itself only
    torch.testing.assert_close(
        got[1], torch.nn.functional.elu(regs["z"][1] + params["b"]), **TOL)
    assert torch.isfinite(got).all()


def test_sg_softmax_cuda_nan_where_plain_puts_it():
    params, regs, batch = _batch(seed=1)
    z = regs["z"].clone()
    z[1, N - 1, 3] = float("inf")      # source of subgraph 1's padding
    z[2, N - 1, 9] = float("nan")      # and of subgraph 2's
    regs = dict(regs, z=z)
    got = _run("cuda", params, regs, batch)
    want = _run("torch", params, regs, batch)
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().any()
    torch.testing.assert_close(got.nan_to_num(), want.nan_to_num(), **TOL)


def test_sg_softmax_sums_one_scatter_gather_call_each(monkeypatch):
    """_sg_softmax_sums reads the kernel's batch axis as (subgraph, head)
    and makes one scatter-gather call for both sums: its output equals
    index_add_ of the same edges, normalised by index_add_'s
    denominator."""
    calls, sg = [], ops.scatter_gather_aggregate

    def counted(*args, **kw):
        calls.append(tuple(args[3].shape))
        return sg(*args, **kw)

    monkeypatch.setattr(ops, "scatter_gather_aggregate", counted)
    params, regs, batch = _batch(seed=2)
    z = regs["z"]
    iota = torch.arange(N, dtype=torch.int32).expand(C, N)
    s_all = torch.cat([batch["edge_src"], iota], 1)
    d_all = torch.cat([batch["edge_dst"], iota], 1)
    ex = torch.rand(C * (E + N), HEADS)
    got = tprog._sg_softmax_sums(s_all, d_all, ex, z, HEADS)
    off = (torch.arange(C) * N)[:, None]
    fs = (s_all.long() + off).reshape(-1)
    fd = (d_all.long() + off).reshape(-1)
    den = torch.zeros(C * N, HEADS).index_add_(0, fd, ex)
    alpha = ex / den[fd].clamp(min=1e-20)
    want = torch.zeros(C * N, HEADS, FH).index_add_(
        0, fd, alpha[:, :, None] * z.reshape(C * N, HEADS, FH)[fs])
    torch.testing.assert_close(got, want, **TOL)
    assert calls == [(C * HEADS, N, FH + 4)]


@pytest.mark.parametrize("n,e,f,want", [
    (256, 18688, 512, 128),     # the sg Aggregates' widths
    (256, 18688, 256, 128),
    (256, 18944, 68, 128),      # the softmax's sums: 64 columns + ones
    (256, 18944, 64, 64),
    (256, 18944, 33, 64),
    (256, 18944, 1, 32),
    (512, 40000, 512, 32),      # capped at the widest that fits
    (256, 65537, 64, 0)])       # past the 16-bit indices: bucket
def test_sort_default_width_follows_f(n, e, f, want):
    """The sort kernel's default columns a block: the narrowest width that
    covers F in one tile, capped at the widest whose shared memory fits
    (the library's scatter_gather_block_cols is checked against it at
    load)."""
    from repro_torch.kernels import scatter_gather
    assert scatter_gather.sort_block_cols(n, e, f) == want
