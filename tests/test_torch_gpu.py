"""CUDA kernels of the PyTorch package on the card: each kernel against its
plain PyTorch version at the serving shapes (C=64, N=256, Fin=512 and 256,
Fout=256, 4 heads, a Flickr-like edge budget) at the fp32 tolerance of
tests/test_kernels.py (the fused layer's three forms on its tf32x3 kernel
at serving and ragged shapes, bitwise repeatable and block_f invariant;
the scatter-gather's weight-0 edges from inf/NaN sources giving NaN where
the plain version does; gat_attention's slab kernel at 1, 2, 4 and 8 heads
and N=200, its row kernel at N=320, empty, dense and all -inf rows, and
inf/NaN in z behind weights of 0 giving NaN where the plain version does),
and one batch of the engine through the kernels
against the plain path; flash_attention against its plain version (fp32
at 2e-5 on ragged and square shapes on the CUDA-core kernel; bf16 to one
ulp there, and to ``flash_bf16_check`` on the wgmma kernel, which rounds P
to bf16), with grouped KV heads, the wgmma kernel at MLA's q/k 192 and v
128 (and MLA's core handing it v unpadded), the cuda_core kernel at
D=192 with v zero-padded by the wrapper, and a reduced dense LM's prefill
through it against the plain path. The scatter-gather's bucket kernel past the
sort kernel's 16-bit edge indices (E = 65,537) and at N=1024 with the
Flickr-sized graph's 74,496 edge slots; the three GNN kernels in bf16
within one bf16 ulp of their plain versions' fp32 results; and a
multi-model server answering through the kernels. The scatter-gather at
the offline build's chunk shape (compact sources, the bucket kernel), the
layer-major build under impl="cuda" against impl="torch", four feature
shards serving the resident store's bits, a tiered engine's all-fresh
and mixed batches, and an engine behind the loopback transport serving
the local engine's bits through the kernels. The reduced mamba2 and Jamba
on the card against the CPU (Jamba's attention on the flash kernel once),
and the chunked SSD against the float64 recurrence on the card. The
wgmma flash kernel at whisper's encoder shape (non-causal, D=64, ragged
S=1500), its D=128 kernel at ragged, grouped and few-item shapes, the reduced whisper and pixtral prefill through the kernel
against the plain path and the CPU, whisper's bf16 policy on the wgmma
kernel, and one LM train step (whisper, and the MoE family's gather
pair) on the card against the CPU. The launch analysis: each kernel's
``note_kernel`` record for one launch equals its ``*_cost``, and a GNN
cell's impl="torch" count on the card equals its ``meta`` count. A traced
engine's ``gpu.*`` layer spans lie inside each batch's device span, and it
serves the untraced bits. Skipped where no CUDA device is
present; on the GPU machine run
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import DTypePolicy  # noqa: E402
from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.core.engine import DecoupledEngine  # noqa: E402
from repro_torch.gnn.model import GNNConfig, init_gnn  # noqa: E402
from repro_torch.graphs.synthetic import get_graph, zipf_traffic  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import fused_gnn, gat_attention, ops  # noqa: E402
from repro_torch.kernels import flash_attention, scatter_gather  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = dict(rtol=2e-5, atol=2e-5)
C, N, F_HID, HEADS, E = 64, 256, 256, 4, 18688


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _adj(rng, c, n):
    a = rng.uniform(size=(c, n, n))
    a = np.where(a < 0.2, a, 0.0).astype(np.float32)
    k = rng.integers(n // 2, n + 1, size=c)
    mask = (np.arange(n)[None, :] < k[:, None]).astype(np.float32)
    return a * mask[:, :, None] * mask[:, None, :], mask


@pytest.mark.parametrize("f_in", [512, 256, 500])
@pytest.mark.parametrize("self_w", [False, True])
def test_fused_gnn_layer(dev, f_in, self_w):
    rng = np.random.default_rng(f_in)
    adj, mask = _adj(rng, C, N)
    h = rng.standard_normal((C, N, f_in)).astype(np.float32) \
        * mask[..., None]
    w = [(rng.standard_normal((f_in, F_HID)) * 0.1).astype(np.float32)
         for _ in range(2)]
    b = (rng.standard_normal(F_HID) * 0.1).astype(np.float32)
    args = [None if a is None else torch.from_numpy(a).to(dev) for a in
            (adj, h, w[0], w[1] if self_w else None, b, mask)]
    before = fused_gnn.launches
    tf32 = fused_gnn.variant_launches["tf32x3"]
    got = fused_gnn.fused_gnn_layer(*args, act="elu")
    torch.cuda.synchronize()
    assert fused_gnn.launches == before + 1
    torch.testing.assert_close(
        got, fused_gnn.fused_gnn_layer_ref(*args, act="elu"), **TOL)
    other = fused_gnn.fused_gnn_layer(*args, act="elu", block_f=64)
    assert torch.equal(got, other)
    assert fused_gnn.variant_launches["tf32x3"] == tf32 + 2


@pytest.mark.parametrize("n,f_in", [(256, 512), (256, 256), (100, 500),
                                    (64, 500), (8, 16)])
@pytest.mark.parametrize("form", ["neigh", "neigh+self", "self"])
def test_fused_tf32x3_forms(dev, n, f_in, form):
    """The three forms of the serving path (A.(H.Wn); + H.Ws; the
    self-only Transform) on the tf32x3 kernel, at serving and ragged shapes:
    within 2e-5, two launches bitwise equal, block_f changes nothing."""
    rng = np.random.default_rng(n + f_in)
    c = 64 if n == 256 else 5
    adj, mask = _adj(rng, c, n)
    h = rng.standard_normal((c, n, f_in)).astype(np.float32) \
        * mask[..., None]
    wn, ws = [(rng.standard_normal((f_in, F_HID)) * 0.1).astype(np.float32)
              for _ in range(2)]
    b = (rng.standard_normal(F_HID) * 0.1).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (adj, h, wn, ws, b, mask)]
    args = {"neigh": (t[0], t[1], t[2], None, t[4], t[5]),
            "neigh+self": (t[0], t[1], t[2], t[3], t[4], t[5]),
            "self": (None, t[1], None, t[3], t[4], t[5])}[form]
    assert fused_gnn.fused_variant(n, f_in, form != "self") == "tf32x3"
    before = dict(fused_gnn.variant_launches)
    got = fused_gnn.fused_gnn_layer(*args, act="elu")
    again = fused_gnn.fused_gnn_layer(*args, act="elu")
    wide = fused_gnn.fused_gnn_layer(*args, act="elu", block_f=128)
    torch.cuda.synchronize()
    assert fused_gnn.variant_launches == dict(before,
                                              tf32x3=before["tf32x3"] + 3)
    torch.testing.assert_close(
        got, fused_gnn.fused_gnn_layer_ref(*args, act="elu"), **TOL)
    assert torch.equal(got, again) and torch.equal(got, wide)


@pytest.mark.parametrize("form", ["neigh", "neigh+self", "self"])
def test_fused_weight_splits_never_stale(dev, form):
    """The tf32x3 kernel reads each weight split once (fused_gnn.
    weight_split): the split made on the card is the CPU's bit for bit;
    two launches and block_f 64 / 128 / 256 are bitwise equal; weights
    given as views of one stacked tensor (as the engine's inner layers)
    make no new split; an in-place update, and a new weight with the same
    _version made right after the old one is freed (the caching allocator
    may give it the freed address), give the plain version's result on
    the new values."""
    rng = np.random.default_rng(31)
    adj, mask = _adj(rng, C, N)
    h = rng.standard_normal((C, N, 512)).astype(np.float32) * mask[..., None]
    w = (rng.standard_normal((2, 512, F_HID)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(F_HID) * 0.1).astype(np.float32)
    adj, mask, h, b = (torch.from_numpy(a).to(dev) for a in (adj, mask, h,
                                                             b))
    stack = torch.from_numpy(w).to(dev)

    def args(ws):
        wn, w_self = {"neigh": (ws[0], None), "neigh+self": (ws[0], ws[1]),
                      "self": (None, ws[1])}[form]
        return (None if wn is None else adj, h, wn, w_self, b, mask)
    for i in range(2):
        assert torch.equal(fused_gnn.weight_split(stack[i]).cpu(),
                           fused_gnn.tf32_split(stack[i].cpu()))
    got = fused_gnn.fused_gnn_layer(*args(stack), act="elu")
    made = fused_gnn.splits_made
    for bf in (64, 128, 256):
        again = fused_gnn.fused_gnn_layer(*args(stack), act="elu",
                                          block_f=bf)
        assert torch.equal(got, again)
    assert fused_gnn.splits_made == made
    torch.testing.assert_close(
        got, fused_gnn.fused_gnn_layer_ref(*args(stack), act="elu"), **TOL)
    stack.mul_(-0.5)
    moved = fused_gnn.fused_gnn_layer(*args(stack), act="elu")
    torch.testing.assert_close(
        moved, fused_gnn.fused_gnn_layer_ref(*args(stack), act="elu"),
        **TOL)
    assert not torch.equal(moved, got)
    version = stack._version
    del stack, got, again, moved
    stack = torch.empty((2, 512, F_HID), device=dev)
    stack.copy_(torch.from_numpy(w[::-1].copy()).to(dev))
    assert stack._version == version
    torch.testing.assert_close(
        fused_gnn.fused_gnn_layer(*args(stack), act="elu"),
        fused_gnn.fused_gnn_layer_ref(*args(stack), act="elu"), **TOL)


@pytest.mark.parametrize("c,n,f_in,f_out,block_f", [
    (3, 37, 45, 48, 16), (2, 8, 16, 16, 256), (1, 70, 130, 200, 100)])
def test_kernels_at_ragged_shapes(dev, c, n, f_in, f_out, block_f):
    """Shapes that are no multiple of any tile: every edge guard runs."""
    rng = np.random.default_rng(n)
    adj, mask = _adj(rng, c, n)
    h = rng.standard_normal((c, n, f_in)).astype(np.float32)
    wn, ws = [(rng.standard_normal((f_in, f_out)) * 0.1).astype(np.float32)
              for _ in range(2)]
    t = [torch.from_numpy(a).to(dev) for a in (adj, h, wn, ws, mask)]
    for w_self in (None, t[3]):
        args = (t[0], t[1], t[2], w_self, None, t[4])
        torch.testing.assert_close(
            fused_gnn.fused_gnn_layer(*args, block_f=block_f),
            fused_gnn.fused_gnn_layer_ref(*args), **TOL)
    e = 3 * n + 5
    src = torch.from_numpy(rng.integers(0, n, (c, e)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, (c, e)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((c, e)).astype(np.float32))
    got = scatter_gather.scatter_gather_aggregate(
        src.to(dev), dst.to(dev), w.to(dev), t[1])
    torch.testing.assert_close(
        got.cpu(), scatter_gather.scatter_gather_aggregate_ref(
            src, dst, w, t[1].cpu()), **TOL)
    heads = 4 if f_out % 4 == 0 else 2
    z = torch.from_numpy(rng.standard_normal((c, n, f_out))
                         .astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.standard_normal((2, c, n, heads))
                         .astype(np.float32)).to(dev)
    st = (t[0] > 0).float() + torch.eye(n, device=dev)
    torch.testing.assert_close(
        gat_attention.gat_attention(z, s[0], s[1], st, n_heads=heads),
        gat_attention.gat_attention_ref(z, s[0], s[1], st, n_heads=heads),
        **TOL)


def test_scatter_gather_aggregate(dev):
    rng = np.random.default_rng(1)
    src = rng.integers(0, N, size=(C, E)).astype(np.int32)
    dst = rng.integers(0, N, size=(C, E)).astype(np.int32)
    w = rng.standard_normal((C, E)).astype(np.float32)
    w[:, 4000:] = 0.0                       # a padding tail
    h = rng.standard_normal((C, N, 512)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (src, dst, w, h)]
    got = scatter_gather.scatter_gather_aggregate(*args)
    torch.cuda.synchronize()
    want = scatter_gather.scatter_gather_aggregate_ref(
        *[a.cpu() for a in args])
    torch.testing.assert_close(got.cpu(), want, **TOL)
    again = scatter_gather.scatter_gather_aggregate(*args)
    assert torch.equal(got, again)          # no atomics: run-to-run equal


def test_scatter_gather_block_cols_widths_bitwise_equal(dev):
    """The sort kernel's columns a block (autotune's knob): every width
    that fits gives the default's bits, at the layer-0 width, the sg
    softmax's (a head's columns, the ones column and padding) and one
    column; each launch is counted at its width."""
    rng = np.random.default_rng(4)
    fh = F_HID // HEADS
    for c, e, f in ((C, E, 512), (C * HEADS, E + N, fh // 4 * 4 + 4),
                    (C * HEADS, E + N, 1)):
        src = rng.integers(0, N, size=(c, e)).astype(np.int32)
        dst = rng.integers(0, N, size=(c, e)).astype(np.int32)
        w = rng.standard_normal((c, e)).astype(np.float32)
        w[:, e // 4:] = 0.0
        h = rng.standard_normal((c, N, f)).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (src, dst, w, h)]
        ops.reset_launch_counts()
        want = scatter_gather.scatter_gather_aggregate(*args)
        default = scatter_gather.sort_block_cols(N, e, f)
        assert scatter_gather.width_launches[default] == 1
        for bc in scatter_gather.BLOCK_COLS_CANDIDATES:
            assert scatter_gather.sort_block_fits(N, e, bc)
            got = scatter_gather.scatter_gather_aggregate(*args,
                                                          block_cols=bc)
            assert torch.equal(got, want), (c, e, f, bc)
            assert scatter_gather.width_launches[bc] == 1 + (bc == default)


def test_gat_sg_device_steps_bitwise_repeatable(dev):
    """gat/sg under impl="cuda": the sg softmax's sums run on the
    scatter-gather kernel, so two device steps of one batch are bitwise
    equal (the plain index_add_ path is not, on a card)."""
    g = get_graph("flickr", scale=0.05, seed=0)
    cfg = GNNConfig(kind="gat", n_layers=3, receptive_field=128,
                    f_in=g.feature_dim, n_heads=HEADS)
    conf = ServingConfig(device="cuda", batch_size=16, mode="sg",
                         impl="cuda", num_threads=2)
    with DecoupledEngine(g, cfg, params=init_gnn(cfg, seed=0, device="cuda"),
                         config=conf) as eng:
        plan = eng.plan(zipf_traffic(g, 16, seed=1))
        ops.reset_launch_counts()
        a = eng.run_device(plan).clone()
        b = eng.run_device(plan).clone()
        torch.cuda.synchronize()
    # one launch a layer (both sums) and step
    assert ops.launch_counts()["scatter_gather_aggregate"] == 2 * 3
    assert torch.equal(a, b)


def test_gat_sg_softmax_sums_count_under_their_caller(dev):
    """Each of gat/sg's scatter-gather launches is its softmax sums: the
    wrapper counts it under ``SG_SOFTMAX_SUMS``, one a layer and step, and
    a gcn/sg step's aggregations under no caller."""
    from repro_torch.core.program import SG_SOFTMAX_SUMS
    g = get_graph("flickr", scale=0.05, seed=0)
    for kind, want in (("gat", 2 * 3), ("gcn", 0)):
        cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=128,
                        f_in=g.feature_dim, n_heads=HEADS)
        conf = ServingConfig(device="cuda", batch_size=16, mode="sg",
                             impl="cuda", num_threads=2)
        with DecoupledEngine(g, cfg, params=init_gnn(cfg, seed=0,
                                                     device="cuda"),
                             config=conf) as eng:
            plan = eng.plan(zipf_traffic(g, 16, seed=1))
            ops.reset_launch_counts()
            eng.run_device(plan)
            eng.run_device(plan)
            torch.cuda.synchronize()
        assert scatter_gather.launches == 2 * 3
        assert scatter_gather.caller_launches.get(SG_SOFTMAX_SUMS, 0) == want


def test_scatter_gather_weight0_edges_from_nonfinite_sources(dev):
    """The oracle's 0 * h[src] on weight-0 edges: NaN exactly where the
    plain version puts it, the rest within 2e-5."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, N, size=(C, E)).astype(np.int32)
    dst = rng.integers(0, N, size=(C, E)).astype(np.int32)
    w = rng.standard_normal((C, E)).astype(np.float32)
    src[:, 4000:] = dst[:, 4000:] = N - 1   # the padding, as the engine's
    w[:, 4000:] = 0.0
    w[1, 17] = 0.0                          # and one inside the list
    h = rng.standard_normal((C, N, 512)).astype(np.float32)
    h[0, N - 1, 1], h[2, N - 1, 511] = np.inf, np.nan
    h[1, src[1, 17], 9] = -np.inf
    args = [torch.from_numpy(a).to(dev) for a in (src, dst, w, h)]
    got = scatter_gather.scatter_gather_aggregate(*args)
    torch.cuda.synchronize()
    want = scatter_gather.scatter_gather_aggregate_ref(
        *[a.cpu() for a in args])
    assert torch.isnan(want).sum() >= 3
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
    torch.testing.assert_close(got.cpu(), want, equal_nan=True, **TOL)


@pytest.mark.parametrize("c,n,e,f", [(2, 256, 65537, 64),
                                     (8, 1024, 74496, 256)])
def test_scatter_gather_refuses_more_edges_than_16_bit_indices(dev, c, n, e,
                                                               f):
    """Edge budgets past the sort kernel's 16-bit indices (E = 65,537) and
    past its shared memory (forced sg on the Flickr-sized graph at N=1024,
    74,496 slots) were refused before launch; the bucket kernel now takes
    them: the plain version's result, NaN from weight-0 edges included,
    bitwise equal over two launches."""
    assert scatter_gather.sg_variant(n, e) == "bucket"
    rng = np.random.default_rng(5)
    live = e // 5
    src = rng.integers(0, n, size=(c, e)).astype(np.int32)
    dst = rng.integers(0, n, size=(c, e)).astype(np.int32)
    w = rng.standard_normal((c, e)).astype(np.float32)
    src[:, live:] = dst[:, live:] = n - 1   # the padding, as the engine's
    w[:, live:] = 0.0
    dst[0, :64] = 3                         # many edges into one vertex
    h = rng.standard_normal((c, n, f)).astype(np.float32)
    h[0, n - 1, 1], h[1, n - 1, f - 1] = np.inf, np.nan
    args = [torch.from_numpy(a).to(dev) for a in (src, dst, w, h)]
    before = scatter_gather.variant_launches["bucket"]
    got = scatter_gather.scatter_gather_aggregate(*args)
    again = scatter_gather.scatter_gather_aggregate(*args)
    torch.cuda.synchronize()
    assert scatter_gather.variant_launches["bucket"] == before + 2
    want = scatter_gather.scatter_gather_aggregate_ref(
        *[a.cpu() for a in args])
    assert torch.isnan(want).sum() >= 2
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
    torch.testing.assert_close(got.cpu(), want, equal_nan=True, **TOL)
    assert torch.equal(got.nan_to_num(), again.nan_to_num())


def _bf16_held(got, want_fp32):
    """A bf16 kernel output against its plain version's fp32 result: within
    one bf16 ulp of it rounded to bf16 (``bf16_reading``), and within the
    reference's 2e-2."""
    from repro_torch.kernels.ref import bf16_reading
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    ok, worst, err = bf16_reading(got, want_fp32)
    assert ok, (worst, err)


@pytest.mark.parametrize("form", ["neigh", "neigh+self", "self"])
def test_fused_gnn_layer_bf16(dev, form):
    rng = np.random.default_rng(6)
    adj, mask = _adj(rng, C, N)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    h = t(rng.standard_normal((C, N, 512)).astype(np.float32)) \
        .to(torch.bfloat16)
    wn, ws = (t(0.05 * rng.standard_normal((512, F_HID)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    b = t(0.1 * rng.standard_normal(F_HID).astype(np.float32)) \
        .to(torch.bfloat16)
    args = (t(adj) if form != "self" else None, h,
            wn if form != "self" else None,
            ws if form != "neigh" else None, b, t(mask))
    before = fused_gnn.variant_launches["wgmma_bf16"]
    got = fused_gnn.fused_gnn_layer(*args)
    assert fused_gnn.variant_launches["wgmma_bf16"] == before + 1
    want = fused_gnn.fused_gnn_layer_ref(
        *[a.float() if a is not None else None for a in args])
    _bf16_held(got, want)


@pytest.mark.parametrize("c,n,f_in,f_out,variant", [
    (64, 256, 512, 256, "wgmma_bf16"),      # the serving shape
    (5, 100, 200, 256, "wgmma_bf16"),       # ragged N, Fin not 64k
    (3, 8, 16, 64, "wgmma_bf16"),           # one k-tile, mostly padding
    (4, 252, 72, 200, "wgmma_bf16"),        # ragged Fout tile
    (2, 64, 500, 256, "cuda_core"),         # rows TMA cannot stride
    (2, 37, 64, 64, "cuda_core")])          # N not a multiple of 4
@pytest.mark.parametrize("form", ["neigh", "neigh+self", "self"])
def test_fused_bf16_variants(dev, c, n, f_in, f_out, variant, form):
    """bf16 on the wgmma_bf16 kernel at every form, ragged N, Fin not a
    multiple of its 64-wide k-tile and a ragged column tile, and on
    cuda_core where TMA cannot stride the rows: within one bf16 ulp of the
    plain version's fp32 result, two launches bitwise equal, both on the
    kernel named (N=37 takes wgmma_bf16 in the self-only form)."""
    rng = np.random.default_rng(n + f_in + f_out)
    adj, mask = _adj(rng, c, n)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    h = t(rng.standard_normal((c, n, f_in)).astype(np.float32)
          * mask[..., None]).to(torch.bfloat16)
    wn, ws = (t(0.05 * rng.standard_normal((f_in, f_out)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    b = t(0.1 * rng.standard_normal(f_out).astype(np.float32)) \
        .to(torch.bfloat16)
    args = (t(adj) if form != "self" else None, h,
            wn if form != "self" else None,
            ws if form != "neigh" else None, b, t(mask))
    if form == "self" and n == 37:
        variant = "wgmma_bf16"
    assert fused_gnn.fused_variant(n, f_in, form != "self", True, True,
                                   f_out) == variant
    before = dict(fused_gnn.variant_launches)
    got = fused_gnn.fused_gnn_layer(*args, act="elu", block_f=f_out)
    again = fused_gnn.fused_gnn_layer(*args, act="elu", block_f=f_out)
    ran = {k: v - before[k] for k, v in fused_gnn.variant_launches.items()}
    assert ran == {k: 2 if k == variant else 0 for k in ran}
    _bf16_held(got, fused_gnn.fused_gnn_layer_ref(
        *[a.float() if a is not None else None for a in args], act="elu"))
    assert torch.equal(got, again)


@pytest.mark.parametrize("n,e", [(N, E), (1024, 74496)])
def test_scatter_gather_aggregate_bf16(dev, n, e):
    rng = np.random.default_rng(7)
    c = C if n == N else 8
    src = rng.integers(0, n, size=(c, e)).astype(np.int32)
    dst = rng.integers(0, n, size=(c, e)).astype(np.int32)
    w = rng.standard_normal((c, e)).astype(np.float32)
    w[:, e // 5:] = 0.0
    h = torch.from_numpy(rng.standard_normal((c, n, F_HID))
                         .astype(np.float32)).to(dev).to(torch.bfloat16)
    args = [torch.from_numpy(a).to(dev) for a in (src, dst, w)] + [h]
    variant = scatter_gather.sg_variant(n, e)
    before = scatter_gather.variant_launches[variant]
    got = scatter_gather.scatter_gather_aggregate(*args)
    assert scatter_gather.variant_launches[variant] == before + 1
    want = scatter_gather.scatter_gather_aggregate_ref(*args[:3], h.float())
    _bf16_held(got, want)


def test_gat_attention_bf16(dev):
    rng = np.random.default_rng(8)
    z, s_src, s_dst, struct = _gat_inputs(rng, C, N, F_HID, HEADS)
    t = [torch.from_numpy(a).to(dev) for a in (z, s_src, s_dst, struct)]
    t[0] = t[0].to(torch.bfloat16)
    before = gat_attention.variant_launches["row"]
    got = gat_attention.gat_attention(*t, n_heads=HEADS)
    assert gat_attention.variant_launches["row"] == before + 1
    want = gat_attention.gat_attention_ref(t[0].float(), *t[1:],
                                           n_heads=HEADS)
    _bf16_held(got, want)


def test_gat_attention(dev):
    rng = np.random.default_rng(2)
    z = rng.standard_normal((C, N, F_HID)).astype(np.float32)
    s = rng.standard_normal((2, C, N, HEADS)).astype(np.float32)
    struct = (rng.uniform(size=(C, N, N)) < 0.3).astype(np.float32)
    struct += np.eye(N, dtype=np.float32)
    struct[:, 7, :] = 0.0                   # a row with no structure
    args = [torch.from_numpy(a).to(dev) for a in (z, s[0], s[1], struct)]
    got = gat_attention.gat_attention(*args, n_heads=HEADS)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, gat_attention.gat_attention_ref(*args, n_heads=HEADS), **TOL)
    assert float(got[:, 7].abs().max()) == 0.0


def _gat_inputs(rng, c, n, f, heads):
    """A sparse structure with self loops (~16 entries a row, as served),
    an empty row 5, a dense row 9, row 11's scores all -inf and the dense
    row 13's too."""
    z = rng.standard_normal((c, n, f)).astype(np.float32)
    s = rng.standard_normal((2, c, n, heads)).astype(np.float32)
    struct = (rng.uniform(size=(c, n, n)) < 16 / n).astype(np.float32)
    struct += np.eye(n, dtype=np.float32)
    struct[:, 5, :] = 0.0
    struct[:, 9, :] = struct[:, 13, :] = 1.0
    s[1, :, 11, :] = s[1, :, 13, :] = -np.inf
    return z, s[0], s[1], struct


def _gat_held(dev, args, heads, variant):
    """Two launches on ``variant``: bitwise equal, NaN where the plain
    version has it, the rest within TOL."""
    t = [torch.from_numpy(a).to(dev) for a in args]
    before = gat_attention.variant_launches[variant]
    got = gat_attention.gat_attention(*t, n_heads=heads)
    again = gat_attention.gat_attention(*t, n_heads=heads)
    torch.cuda.synchronize()
    assert gat_attention.variant_launches[variant] == before + 2
    want = gat_attention.gat_attention_ref(*[a.cpu() for a in t],
                                           n_heads=heads)
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), again.cpu().nan_to_num())
    torch.testing.assert_close(got, want, equal_nan=True, **TOL)
    return got


@pytest.mark.parametrize("n,heads,variant", [
    (256, 4, "slab"), (256, 1, "slab"), (256, 2, "slab"), (256, 8, "slab"),
    (200, 4, "slab"), (320, 4, "row")])
def test_gat_attention_kernels(dev, n, heads, variant):
    assert gat_attention.gat_variant(n, F_HID, heads,
                                      aligned=True) == variant
    rng = np.random.default_rng(n + heads)
    got = _gat_held(dev, _gat_inputs(rng, 8, n, F_HID, heads), heads,
                    variant)
    assert float(got[:, 5].abs().max()) == 0.0      # empty
    assert float(got[:, 11].abs().max()) == 0.0     # scores all -inf
    assert bool(torch.isnan(got[:, 13]).all())      # dense, all -inf


def test_gat_attention_nonfinite_z_behind_zero_weights(dev):
    """inf/NaN in z rows outside destinations' structure and behind a
    structural weight that underflows to 0: NaN where the plain version
    (the oracle's attn @ z) has it; behind a subnormal weight: inf."""
    rng = np.random.default_rng(9)
    z, s_src, s_dst, struct = _gat_inputs(rng, 4, N, F_HID, HEADS)
    z[0, 20, 1], z[1, 30, 100], z[3, N - 1, 255] = np.inf, np.nan, -np.inf
    struct[2, 40, 41] = 1.0
    s_src[2, 41, 0] = -1e4                  # e ~ -2000 at 41 -> 40
    z[2, 41, 3] = np.inf
    struct[2, 50, 51] = 1.0
    s_dst[2, 50, 0], s_src[2, 50, 0], s_src[2, 51, 0] = 0.0, 0.0, -475.0
    z[2, 51, 5] = np.inf                    # behind e^-95, subnormal
    got = _gat_held(dev, (z, s_src, s_dst, struct), HEADS, "slab")
    assert bool(torch.isnan(got[2, 40, 3]))
    assert bool(torch.isnan(got[0, :, 1]).any())


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("mode", ["dense", "sg"])
def test_engine_batch_through_kernels(dev, kind, mode):
    g = get_graph("flickr", scale=0.05, seed=0)
    cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=128,
                    f_in=g.feature_dim)
    params = init_gnn(cfg, seed=0, device="cuda")
    targets = zipf_traffic(g, 16, seed=1)
    out = {}
    for impl in ("cuda", "torch"):
        ops.reset_launch_counts()
        conf = ServingConfig(device="cuda", batch_size=16, mode=mode,
                             impl=impl, num_threads=2)
        with DecoupledEngine(g, cfg, params=params, config=conf) as eng:
            out[impl] = eng.infer(targets).embeddings
        launched = sum(ops.launch_counts().values())
        assert (launched > 0) == (impl == "cuda")
    np.testing.assert_allclose(out["cuda"], out["torch"], rtol=1e-4,
                               atol=1e-5)


def test_server_round_trip_through_kernels(dev):
    """A GNNServer with a GCN (sg), GraphSAGE (dense, resident store) and
    GAT (dense) lane answers through the three GNN kernels, each request
    equal to its engine's infer."""
    from repro_torch.serve.gnn_server import GNNServer
    from repro_torch.store import StorePolicy
    g = get_graph("flickr", scale=0.05, seed=0)
    lanes = {"gcn": ("sg", "dense"), "sage": ("dense", "resident"),
             "gat": ("dense", "dense")}
    srv = GNNServer(max_wait_s=0.01)
    for kind, (mode, features) in lanes.items():
        cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=128,
                        f_in=g.feature_dim)
        srv.register(kind, DecoupledEngine(g, cfg, config=ServingConfig(
            device="cuda", batch_size=16, mode=mode, num_threads=2,
            store=StorePolicy(features=features))))
    ops.reset_launch_counts()
    srv.start()
    reqs = [srv.submit(int(t), model=k)
            for k in lanes for t in zipf_traffic(g, 32, seed=2)]
    srv.drain(reqs, timeout=300)
    srv.stop()
    counts = ops.launch_counts()
    for k in ("fused_gnn_layer", "scatter_gather_aggregate",
              "gat_attention"):
        assert counts[k] > 0, counts
    for kind in lanes:
        mine = [r for r in reqs if r.model == kind]
        eng = srv.engine_for(kind)
        want = eng.infer(np.array([r.target for r in mine])).embeddings
        np.testing.assert_allclose(np.stack([r.embedding for r in mine]),
                                   want, rtol=1e-4, atol=1e-5)
        eng.close()


@pytest.mark.parametrize("kind,calibrate_every", [
    ("gcn", 0), ("gat", 0), ("gcn", 1)])
def test_traced_batches_time_each_layer_on_the_card(dev, kind,
                                                    calibrate_every):
    """An engine with its tracer attached serves the bits of an untraced
    one; each traced batch gets L ``gpu.layer`` spans and one
    ``gpu.tail`` (GAT: L ``gpu.attention``), inside its ``device`` span on
    the host's clock within the anchor's round trip; a sampled calibration
    pass adds no span of its own."""
    from repro_torch.obs import TraceConfig
    g = get_graph("flickr", scale=0.05, seed=0)
    layers = 3
    cfg = GNNConfig(kind=kind, n_layers=layers, receptive_field=128,
                    f_in=g.feature_dim)
    params = init_gnn(cfg, seed=0, device="cuda")
    targets = zipf_traffic(g, 64, seed=1)
    conf = ServingConfig(device="cuda", batch_size=16, num_threads=2)
    with DecoupledEngine(g, cfg, params=params, config=conf) as eng:
        want = eng.infer(targets).embeddings
    with DecoupledEngine(g, cfg, params=params, config=conf) as eng:
        tracer = eng.attach_tracer(
            TraceConfig(calibrate_every=calibrate_every))
        got = eng.infer(targets).embeddings
        spans = tracer.export_spans()
        rtt = eng.trace_report()["gpu_anchor_rtt_us"] * 1e-6
    np.testing.assert_array_equal(want, got)
    roots = [s for s in spans if s["name"] == "batch"]
    assert len(roots) == len(targets) // 16
    for root in roots:
        mine = [s for s in spans if s["trace_id"] == root["trace_id"]]
        dev_span = next(s for s in mine if s["name"] == "device")
        gpu = [s for s in mine if s["name"].startswith("gpu.")]
        names = [s["name"] for s in gpu]
        assert set(names) <= {"gpu.input", "gpu.layer", "gpu.attention",
                              "gpu.tail"}
        assert names.count("gpu.tail") == names.count("gpu.input") == 1
        assert sorted(s["args"]["l"] for s in gpu
                      if s["name"] == "gpu.layer") == list(range(layers))
        assert names.count("gpu.attention") == (layers if kind == "gat"
                                                else 0)
        assert all(s["dur"] >= 0 for s in gpu)
        step = sum(s["dur"] for s in gpu if s["name"] != "gpu.attention")
        assert step <= dev_span["dur"]
        lo, hi = dev_span["t0"], dev_span["t0"] + dev_span["dur"]
        for s in gpu:
            assert s["parent_id"] == dev_span["span_id"]
            assert lo - rtt <= s["t0"] and s["t0"] + s["dur"] <= hi + rtt


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 2, 64, 64, 32, True), (2, 1, 128, 128, 64, False),
    (1, 2, 64, 128, 32, False), (1, 3, 1000, 1000, 128, True),
    (2, 2, 130, 77, 16, True), (1, 2, 100, 300, 256, False)])
def test_flash_attention(dev, b, h, sq, sk, d, causal):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                .astype(np.float32)).to(dev)
               for s in (sq, sk, sk))
    before = dict(flash_attention.variant_launches)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.variant_launches["cuda_core"] == \
        before["cuda_core"] + 1
    torch.testing.assert_close(got, flash_attention.flash_attention_ref(
        q, k, v, causal=causal), **TOL)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    variant = flash_attention.flash_variant(torch.bfloat16, d)
    got = flash_attention.flash_attention(qb, kb, vb, causal=causal)
    assert got.dtype == torch.bfloat16
    if variant == "wgmma":
        # P rounded to bf16 before P.V: (a) within flash_bf16_tol, (b) mean
        # signed error within 0.1 ulp, (c) two launches bitwise equal
        again = flash_attention.flash_attention(qb, kb, vb, causal=causal)
        r = flash_attention.flash_bf16_check(
            got, again, flash_attention.flash_attention_ref(
                qb.float(), kb.float(), vb.float(), causal=causal),
            flash_attention.flash_bf16_tol(qb, kb, vb, causal=causal))
        assert r["ok"], r
        assert flash_attention.variant_launches["wgmma"] == \
            before["wgmma"] + 2
        return
    want = flash_attention.flash_attention_ref(qb, kb, vb, causal=causal)
    # both sides compute in fp32 and round once: at most one bf16 ulp
    # apart, and nearly all bitwise equal (as chip_smoke.py holds them)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-5)
    assert float((got == want).float().mean()) >= 0.99
    assert flash_attention.variant_launches["cuda_core"] == \
        before["cuda_core"] + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,d", [(1, 128), (2, 64), (4, 128)])
def test_flash_attention_reads_grouped_kv_heads(dev, dtype, kh, d):
    """k/v with Kh of 8 heads against the plain version on K/V repeated."""
    rng = np.random.default_rng(kh * d)
    q = torch.from_numpy(rng.standard_normal((2, 8, 300, d))
                         .astype(np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, kh, 300, d))
                             .astype(np.float32)).to(dev, dtype)
            for _ in range(2))
    got = flash_attention.flash_attention(q, k, v)
    k8, v8 = (t.repeat_interleave(8 // kh, dim=1) for t in (k, v))
    if dtype == torch.float32:
        torch.testing.assert_close(
            got, flash_attention.flash_attention_ref(q, k8, v8), **TOL)
        return
    r = flash_attention.flash_bf16_check(
        got, flash_attention.flash_attention(q, k, v),
        flash_attention.flash_attention_ref(q.float(), k8.float(),
                                            v8.float()),
        flash_attention.flash_bf16_tol(q, k8, v8))
    assert r["ok"], r


def test_flash_attention_refuses_a_head_dim_over_shared_memory(dev):
    q = torch.zeros(1, 1, 64, 512, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention.flash_attention(q, q, q)


def test_lm_head_keeps_the_fp32_hidden_state(dev):
    """bf16 compute: the card's LM head (hi + lo bf16 halves of the fp32
    hidden state on the tensor cores) against the CPU's fp32 product."""
    cfg = dataclasses.replace(
        get_config("phi3-medium-14b", reduced=True),
        dtype=DTypePolicy(param_dtype="float32", compute_dtype="bfloat16"))
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 37, 512))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((512, 1000)) / 512 ** 0.5)
                         .astype(np.float32))
    want = transformer._unembed(cfg, {"lm_head": w}, h)
    got = transformer._unembed(cfg, {"lm_head": w.to(dev)}, h.to(dev))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_lm_prefill_through_flash_attention(dev):
    """A reduced phi3 (fp32, GQA 4:2) over a ragged 40-token prompt: one
    launch a layer, logits allclose to the plain path on the card."""
    cfg = get_config("phi3-medium-14b", reduced=True)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(dev)
    ops.reset_launch_counts()
    got = transformer.prefill(cfg, params, {"tokens": tokens}, impl="cuda")
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want = transformer.prefill(cfg, params, {"tokens": tokens}, impl="torch")
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("f", [500, 256])
def test_scatter_gather_at_the_offline_chunk_shape(dev, f):
    """The offline build's Aggregate: each chunk of 256 destinations in
    the compact form (its distinct sources gathered from the [V, f]
    register, N = max(chunk, sources)), on the kernel sg_variant names,
    against the plain version; two launches bitwise equal; a non-finite
    row 0 (the padding edges' source) gives NaN where the plain version
    does."""
    from repro_torch.precompute.propagate import _LocalCSR
    g = get_graph("flickr", scale=0.05, seed=0)
    local = _LocalCSR(g, np.arange(g.num_vertices), 256, "cuda", dev)
    H = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (g.num_vertices, f)).astype(np.float32)).to(dev)
    H[0, 3] = float("inf")
    for i in range(local.num_chunks):
        rows, src, dst, nrows = local._chunks[i]
        h = torch.zeros(1, nrows, f, device=dev)
        h[0, :len(rows)] = H.index_select(0, rows)
        w = local._weights("gcn")[i]
        before = dict(scatter_gather.variant_launches)
        got = scatter_gather.scatter_gather_aggregate(src, dst, w, h)
        again = scatter_gather.scatter_gather_aggregate(src, dst, w, h)
        variant = scatter_gather.sg_variant(nrows, src.shape[1])
        assert scatter_gather.variant_launches[variant] == \
            before[variant] + 2
        want = scatter_gather.scatter_gather_aggregate_ref(src, dst, w, h)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(again))


def _same_bits(got, want):
    torch.cuda.synchronize()
    ng, nw = torch.isnan(got), torch.isnan(want)
    return bool(torch.equal(ng, nw)) and bool(torch.equal(got[~ng],
                                                          want[~nw]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_gather_bucket_n_out_below_n(dev, dtype):
    """The bucket kernel with n_out < N: [C, n_out, F], bitwise the first
    n_out rows of its N-row output (edges to destinations at or past n_out
    dropped), against the plain version with NaN from weight-0 edges of
    inf/NaN sources; two launches bitwise equal; launches counted."""
    c, n, n_out, e, f = 3, 3000, 700, 70000, 132
    assert scatter_gather.sg_variant(n, e) == "bucket"
    rng = np.random.default_rng(7)
    src = rng.integers(0, n, size=(c, e)).astype(np.int32)
    dst = rng.integers(0, n_out, size=(c, e)).astype(np.int32)
    dst[:, ::3] = rng.integers(0, n, size=dst[:, ::3].shape)
    w = rng.standard_normal((c, e)).astype(np.float32)
    w[:, 60000:] = 0.0
    src[:, 60000:] = n - 1
    dst[:, 60000:] = 5
    h = rng.standard_normal((c, n, f)).astype(np.float32)
    h[1, n - 1, 4], h[2, n - 1, f - 1] = np.inf, np.nan
    args = [torch.from_numpy(a).to(dev) for a in (src, dst, w)] + [
        torch.from_numpy(h).to(dev).to(dtype)]
    before = scatter_gather.variant_launches["bucket"]
    got = scatter_gather.scatter_gather_aggregate(*args, n_out=n_out)
    again = scatter_gather.scatter_gather_aggregate(*args, n_out=n_out)
    full = scatter_gather.scatter_gather_aggregate(*args)
    assert scatter_gather.variant_launches["bucket"] == before + 3
    assert tuple(got.shape) == (c, n_out, f) and got.dtype == dtype
    assert _same_bits(got, again) and _same_bits(got, full[:, :n_out])
    want = scatter_gather.scatter_gather_aggregate_ref(
        *args[:3], args[3].float(), n_out=n_out)
    assert torch.isnan(want).sum() >= 2
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)
    else:
        fin = torch.isfinite(want)
        _bf16_held(got[fin], want[fin])


@pytest.mark.parametrize("f", [96, 500])
def test_scatter_gather_bucket_hub_spanning_tiles(dev, f):
    """A hub destination whose ~9,900 live edges span all of the bucket
    kernel's tiles, beside 63 rows of ~890 edges (all over 512: each row
    split over 8-column blocks): every row bitwise equal to the same
    products and sums
    taken one edge at a time in edge order in float32 (numpy; the plain
    version's index_add_ adds in another order on the card); two launches
    bitwise equal."""
    c, n, e, hub = 1, 5000, 66000, 11
    rng = np.random.default_rng(f)
    src = rng.integers(0, n, size=(c, e)).astype(np.int32)
    dst = rng.integers(0, 64, size=(c, e)).astype(np.int32)
    dst[0, rng.choice(e, 9000, replace=False)] = hub
    at = np.flatnonzero(dst[0] == hub)          # in edge order
    w = rng.standard_normal((c, e)).astype(np.float32)
    h = rng.standard_normal((c, n, f)).astype(np.float32)
    tiles = scatter_gather.BUCKET_TILE
    assert len(set(at // tiles)) == -(-e // tiles)
    args = [torch.from_numpy(a).to(dev) for a in (src, dst, w, h)]
    got = scatter_gather.scatter_gather_aggregate(*args, n_out=64)
    again = scatter_gather.scatter_gather_aggregate(*args, n_out=64)
    assert _same_bits(got, again)
    want = np.zeros((64, f), np.float32)
    for k in range(e):
        want[dst[0, k]] = want[dst[0, k]] + h[0, src[0, k]] * w[0, k]
    assert np.array_equal(got[0].cpu().numpy(), want)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_offline_build_cuda_against_torch(dev, kind):
    """The layer-major build under impl="cuda" (every Aggregate on the
    scatter-gather kernel, counted: chunks x Aggregates) against the same
    build under impl="torch" on the card; two cuda builds bitwise equal."""
    from repro_torch.core.program import lower, specialize
    from repro_torch.precompute import agg_hops, layer_major_embeddings
    g = get_graph("flickr", scale=0.05, seed=0)
    cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=128,
                    f_in=g.feature_dim, readout="target")
    prog, _ = specialize(lower(cfg), n=128, f_in=g.feature_dim)
    params = init_gnn(cfg, seed=0, device="cuda")
    ops.reset_launch_counts()
    got = layer_major_embeddings(g, prog, params, chunk_size=512,
                                 impl="cuda", device="cuda")
    chunks = -(-g.num_vertices // 512)
    assert ops.launch_counts()["scatter_gather_aggregate"] == \
        chunks * agg_hops(prog)
    again = layer_major_embeddings(g, prog, params, chunk_size=512,
                                   impl="cuda", device="cuda")
    np.testing.assert_array_equal(got, again)
    want = layer_major_embeddings(g, prog, params, chunk_size=512,
                                  impl="torch", device="cuda")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind,mode", [("gcn", "sg"), ("sage", "dense"),
                                       ("gat", "dense")])
def test_sharded_engine_bitwise_equal_to_resident(dev, kind, mode):
    """Four shards (one card each where the host has four, else simulated
    on the one card) serve the resident-store engine's bits through the
    kernels."""
    from repro_torch.store import StorePolicy
    g = get_graph("flickr", scale=0.05, seed=0)
    cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=128,
                    f_in=g.feature_dim)
    params = init_gnn(cfg, seed=0, device="cuda")
    targets = zipf_traffic(g, 32, seed=1)
    out = {}
    for features, extra in (("resident", {}),
                            ("sharded", {"num_shards": 4}),
                            ("sharded", {"num_shards": 4,
                                         "placement": "range"})):
        conf = ServingConfig(device="cuda", batch_size=16, mode=mode,
                             impl="cuda", num_threads=2,
                             store=StorePolicy(features=features, **extra))
        with DecoupledEngine(g, cfg, params=params, config=conf) as eng:
            out[features, extra.get("placement")] = \
                eng.infer(targets).embeddings
            rep = eng.store_report()["features"]
        if features == "sharded":
            four = torch.cuda.device_count() >= 4
            assert rep["simulated"] is not four
            assert rep["devices"] == ([f"cuda:{i}" for i in range(4)]
                                      if four else ["cuda:0"] * 4)
            assert rep["cross_shard_rows"] > 0
    want = out["resident", None]
    for key, got in out.items():
        np.testing.assert_array_equal(got, want, err_msg=str(key))


def test_tier_engine_all_fresh_and_mixed(dev):
    """A tiered GCN engine on the card: an all-fresh batch launches
    nothing and returns the tier's rows; a mixed batch after a demotion
    runs the program once, its online rows equal to an online engine's."""
    from repro_torch.precompute import PrecomputeConfig
    g = get_graph("flickr", scale=0.05, seed=0)
    cfg = GNNConfig(kind="gcn", n_layers=2, receptive_field=128,
                    f_in=g.feature_dim, readout="target")
    params = init_gnn(cfg, seed=0, device="cuda")
    targets = zipf_traffic(g, 16, seed=1)
    base = ServingConfig(device="cuda", batch_size=16, mode="sg",
                         impl="cuda", num_threads=2)
    tiered = dataclasses.replace(base, precompute=PrecomputeConfig(
        chunk_size=512, auto_refresh=False))
    with DecoupledEngine(g, cfg, params=params, config=tiered) as hy, \
            DecoupledEngine(g, cfg, params=params, config=base) as on:
        tier = hy.precompute.tier
        ops.reset_launch_counts()
        got = hy.infer(targets).embeddings
        assert sum(ops.launch_counts().values()) == 0
        np.testing.assert_array_equal(got, tier.table[tier.slot_of[targets]])
        tier.demote(targets[:5])
        fresh = tier.fresh[tier.slot_of[targets]]
        want = on.infer(targets).embeddings
        ops.reset_launch_counts()
        got = hy.infer(targets).embeddings
        assert ops.launch_counts()["fused_gnn_layer"] == 2
        np.testing.assert_allclose(got[~fresh], want[~fresh], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(
            got[fresh], tier.table[tier.slot_of[targets[fresh]]])


@pytest.mark.parametrize("kind,mode", [("gcn", "sg"), ("sage", "dense"),
                                       ("gat", "dense")])
def test_inproc_remote_engine_bitwise_equal_to_local(dev, kind, mode):
    """Select/Build behind the loopback transport (the full wire codec),
    Pack and the program on the card under impl="cuda": every batch
    bitwise equal to the local engine's, through the kernels."""
    g = get_graph("flickr", scale=0.05, seed=0)
    cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=128,
                    f_in=g.feature_dim)
    params = init_gnn(cfg, seed=0, device="cuda")
    targets = zipf_traffic(g, 48, seed=4)
    out = {}
    for transport in ("local", "inproc"):
        ops.reset_launch_counts()
        conf = ServingConfig(device="cuda", batch_size=16, mode=mode,
                             impl="cuda", num_threads=2,
                             transport=transport)
        with DecoupledEngine(g, cfg, params=params, config=conf) as eng:
            out[transport] = eng.infer(targets).embeddings
            calls = eng.scheduler.stats.rpc_calls
        assert sum(ops.launch_counts().values()) > 0
        assert calls == (3 if transport == "inproc" else 0)
    np.testing.assert_array_equal(out["inproc"], out["local"])


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
def test_gnn_train_step_on_the_card_matches_the_cpu(dev, kind):
    """One training step (the plain program under autograd, AdamW) on the
    card against the same step on the CPU, with the same params and batch:
    loss and grad_norm at rtol 1e-5, acc within one target, every
    gradient leaf at 1e-5 of its largest |g| (tests/test_torch_train.py's
    tolerances); no kernel launched."""
    from repro_torch.gnn import train as gtrain
    from repro_torch.train.optim import AdamWConfig, init_opt, tree_leaves
    g = get_graph("flickr", scale=0.02, seed=1)
    cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=64,
                    f_in=g.feature_dim, f_hidden=64,
                    num_classes=int(g.labels.max()) + 1)
    targets = np.random.default_rng(0).integers(0, g.num_vertices, 16)
    ops.reset_launch_counts()
    out = {}
    for d in ("cpu", "cuda"):
        params = init_gnn(cfg, seed=0, device=d)
        batch, labels = gtrain.train_batch(g, cfg, targets, d)
        loss, acc, grads = gtrain.gnn_grads(cfg, params, batch, labels)
        opt = AdamWConfig(lr=3e-3, weight_decay=0.0)
        _, _, m = gtrain.make_gnn_train_step(cfg, opt)(
            params, init_opt(params, opt), batch, labels)
        out[d] = (loss, acc, grads, m)
    assert all(n == 0 for n in ops.launch_counts().values())
    (l0, a0, g0, m0), (l1, a1, g1, m1) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m0["grad_norm"]),
                               rtol=1e-5)
    assert abs(float(a1) - float(a0)) <= 1.0 / len(targets)
    for got, want in zip(tree_leaves(g1), tree_leaves(g0)):
        assert got.is_cuda
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_mla_core_through_flash_attention_at_d192(dev):
    """MLA prefill's core under impl="cuda": q and k 192 wide (128 nope +
    64 rope, the rope key shared by the 16 heads), v at its own 128, bf16,
    a ragged 300-token prompt, on the wgmma kernel (two launches, v handed
    over unpadded); held to flash_bf16_check against the plain version
    (fp32) on the same inputs."""
    from repro_torch.models import mla
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H = 1, 300, 16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    qn, qr, kn, kr, v = (rnd(B, S, H, 128), rnd(B, S, H, 64),
                         rnd(B, S, H, 128), rnd(B, S, 1, 64),
                         rnd(B, S, H, 128))
    seen = []
    real = mla.flash_attention

    def spy(q, k, v, *, causal=True):
        seen.append(tuple(v.shape))
        return real(q, k, v, causal=causal)
    before = dict(flash_attention.variant_launches)
    mla.flash_attention = spy
    try:
        got = mla._flash_core(qn, qr, kn, kr, v, True)
        again = mla._flash_core(qn, qr, kn, kr, v, True)
    finally:
        mla.flash_attention = real
    assert seen == [(B, H, S, 128)] * 2
    assert flash_attention.variant_launches["wgmma"] == before["wgmma"] + 2
    assert flash_attention.variant_launches["cuda_core"] == \
        before["cuda_core"]
    q = torch.cat([qn, qr], -1).transpose(1, 2).contiguous()
    k = torch.cat([kn, kr.expand(B, S, H, 64)], -1).transpose(1, 2) \
        .contiguous()
    vt = v.transpose(1, 2).contiguous()
    want = flash_attention.flash_attention_ref(q.float(), k.float(),
                                               vt.float())
    r = flash_attention.flash_bf16_check(
        got.transpose(1, 2), again.transpose(1, 2), want,
        flash_attention.flash_bf16_tol(q, k, vt))
    assert r["ok"], r


@pytest.mark.parametrize("h,kh", [(2, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 127, 128, 300])
def test_flash_wgmma_at_d192_v128(dev, s, causal, h, kh):
    """The wgmma kernel at q/k 192 and v 128 (MLA's widths): ragged and
    exact tiles, one row, causal and not, H = Kh and grouped KV heads;
    held by flash_bf16_check (within tolerance, mean signed error within
    0.1 ulp, two launches bitwise equal)."""
    gen = torch.Generator(device=dev).manual_seed(s + 7 * h)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = rnd(2, h, s, 192), rnd(2, kh, s, 192), rnd(2, kh, s, 128)
    assert flash_attention.flash_variant(q.dtype, 192, 128) == "wgmma"
    before = flash_attention.variant_launches["wgmma"]
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    again = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.variant_launches["wgmma"] == before + 2
    assert tuple(got.shape) == (2, h, s, 128)
    k2, v2 = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
    r = flash_attention.flash_bf16_check(
        got, again, flash_attention.flash_attention_ref(
            q.float(), k2.float(), v2.float(), causal=causal),
        flash_attention.flash_bf16_tol(q, k2, v2, causal=causal))
    assert r["ok"], r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cuda_core_at_d192(dev, dtype):
    """At q/k 192 and v 128 in fp32, and at (192, 192) in bf16 (no wgmma
    kernel fits that), the cuda_core kernel: the wrapper zero-pads v to
    192 and slices the output; held to the plain version at v's width."""
    rng = np.random.default_rng(11)
    dv = 128 if dtype == torch.float32 else 192
    q, k = (torch.from_numpy(rng.standard_normal((1, 2, 300, 192))
                             .astype(np.float32)).to(dev, dtype)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 2, 300, dv))
                         .astype(np.float32)).to(dev, dtype)
    assert flash_attention.flash_variant(dtype, 192, dv) == "cuda_core"
    before = flash_attention.variant_launches["cuda_core"]
    got = flash_attention.flash_attention(q, k, v)
    assert flash_attention.variant_launches["cuda_core"] == before + 1
    assert tuple(got.shape) == (1, 2, 300, dv) and got.is_contiguous()
    want = flash_attention.flash_attention_ref(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=2e-5)


def test_moe_prefill_bitwise_repeatable(dev):
    """Two impl="cuda" prefills of a reduced deepseek-v2-lite in bf16
    compute over 256 tokens (capacity drops included) are bitwise equal:
    the combine sums each token's contributions in a fixed order."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite-16b", reduced=True),
        dtype=DTypePolicy(param_dtype="float32", compute_dtype="bfloat16"))
    params = transformer.init_params(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 256))).to(dev)
    a = transformer.prefill(cfg, params, {"tokens": tokens}, impl="cuda")
    b = transformer.prefill(cfg, params, {"tokens": tokens}, impl="cuda")
    assert torch.equal(a, b)
    x = torch.randn(1, 256, cfg.d_model, device=dev, dtype=torch.bfloat16)
    p = {k: v[1] if k != "shared" else {kk: vv[1] for kk, vv in v.items()}
         for k, v in params["blocks"]["ffn"].items()}
    p = {k: (v.to(torch.bfloat16) if k != "shared" else
             {kk: vv.to(torch.bfloat16) for kk, vv in v.items()})
         for k, v in p.items()}
    for fn in (moe.moe_ffn, moe.moe_ffn_gather):
        y1, _ = fn(p, x, cfg.moe)
        y2, _ = fn(p, x, cfg.moe)
        assert torch.equal(y1, y2)


def test_kernel_wrappers_refuse_autograd(dev):
    """A CUDA tensor that requires grad, with grad mode on: each wrapper
    raises (its kernel has no backward, and its output would carry no
    grad_fn), and launches under torch.no_grad()."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    adj, h, w = t(2, 16, 16), t(2, 16, 8), t(8, 8)
    src = torch.randint(0, 16, (2, 32), device=dev, dtype=torch.int32)
    dst = torch.randint(0, 16, (2, 32), device=dev, dtype=torch.int32)
    ew, z, s = t(2, 32), t(2, 16, 8), t(2, 16, 2)
    q = t(1, 2, 16, 32)
    calls = [
        (lambda x: fused_gnn.fused_gnn_layer(adj, h, x), w),
        (lambda x: scatter_gather.scatter_gather_aggregate(src, dst, ew, x),
         h),
        (lambda x: gat_attention.gat_attention(x, s, s, (adj > 0).float(),
                                               n_heads=2), z),
        (lambda x: flash_attention.flash_attention(x, q, q), q.clone()),
    ]
    for call, x in calls:
        x.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            call(x)
        with torch.no_grad():
            assert call(x).is_cuda


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_ssm_and_hybrid_on_the_card_match_the_cpu(dev, name):
    """The reduced mamba2 and Jamba (one period, 4 experts; fp32) on the
    card against the same params on the CPU: prefill on both impls (Jamba's
    attention through flash_attention once under impl="cuda", never under
    impl="torch") and four decode steps, at tests/test_torch_lm.py's fp32
    tolerances (rtol 1e-4, atol 1e-5 of the largest |logit|; decode 1e-3)."""
    cfg = get_config(name, reduced=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 64)))
    want = transformer.prefill(cfg, params, {"tokens": tokens},
                               impl="torch")
    scale = max(1.0, float(want.abs().max()))
    n_attn = 1 if cfg.hybrid_attn_period else 0
    for impl in ("cuda", "torch"):
        ops.reset_launch_counts()
        got = transformer.prefill(cfg, on_card, {"tokens": tokens.to(dev)},
                                  impl=impl)
        assert ops.launch_counts()["flash_attention"] == (
            n_attn if impl == "cuda" else 0)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-5 * scale)
    cache = transformer.init_cache(cfg, 2, 8, device="cpu")
    card_cache = transformer.init_cache(cfg, 2, 8, device="cuda")
    for pos in range(4):
        tok = tokens[:, pos:pos + 1]
        want, cache = transformer.decode_step(cfg, params, cache, tok, pos)
        got, card_cache = transformer.decode_step(cfg, on_card, card_cache,
                                                  tok.to(dev), pos)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-3 * scale)


def test_ssd_chunked_on_the_card(dev):
    """ssd_chunked on the card (fp32, TF32 off) against the step-by-step
    recurrence in float64 on the card, output and final state within 1e-4
    of their largest magnitude, and two runs bitwise equal."""
    from repro_torch.models import mamba
    gen = torch.Generator(device=dev).manual_seed(0)
    b, S, H, P, N, chunk = 1, 1024, 8, 64, 128, 256
    x = torch.randn(b, S, H, P, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, H, generator=gen, device=dev) - 2)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    B, C = (torch.randn(b, S, H, N, generator=gen, device=dev) * 0.1
            for _ in range(2))
    y, st = mamba.ssd_chunked(x, dt, A, B, C, chunk)
    y2, st2 = mamba.ssd_chunked(x, dt, A, B, C, chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y64, st64 = mamba.ssd_reference(
        *(t.double() for t in (x, dt, A, B, C)), dtype=torch.float64,
        return_state=True)
    for got, want in ((y, y64), (st, st64)):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("h,kh", [(6, 6), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(1, 1), (100, 100), (128, 128),
                                   (448, 448), (300, 777), (777, 300),
                                   (1500, 1500)])
def test_flash_wgmma_at_d64(dev, sq, sk, causal, h, kh):
    """The D=64 wgmma instance (three consumer warpgroups, a persistent
    grid, Q.K^T issued before the previous tile's softmax ends): one row,
    S < 128, exact tiles, whisper's decoder and encoder lengths, Sq != Sk
    both ways, causal and not, H = Kh and grouped KV heads; held by
    flash_bf16_check."""
    gen = torch.Generator(device=dev).manual_seed(sq + 3 * sk + h)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = rnd(2, h, sq, 64), rnd(2, kh, sk, 64), rnd(2, kh, sk, 64)
    assert flash_attention.flash_variant(q.dtype, 64) == "wgmma"
    before = flash_attention.variant_launches["wgmma"]
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    again = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.variant_launches["wgmma"] == before + 2
    k2, v2 = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
    r = flash_attention.flash_bf16_check(
        got, again, flash_attention.flash_attention_ref(
            q.float(), k2.float(), v2.float(), causal=causal),
        flash_attention.flash_bf16_tol(q, k2, v2, causal=causal))
    assert r["ok"], r


@pytest.mark.parametrize("h,kh", [(5, 1), (8, 1), (4, 4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(1, 1), (100, 100), (128, 128),
                                   (300, 777), (777, 300), (2000, 2000)])
def test_flash_wgmma_at_d128(dev, sq, sk, causal, h, kh):
    """The D=128 wgmma instance (two consumer warpgroups taking turns at the
    tensor cores, Q.K^T issued before the previous tile's softmax ends, a
    persistent grid of min(items, SMs) blocks), B=2: fewer items than SMs
    (B*H*ceil(Sq/128) from 2 to 48) and a count that is no multiple of 132
    (256 items at Sq=2000, H=8), ragged Sq with the second warpgroup's rows
    past Sq (1, 300, 777) and inside it (100, 2000), Sk != Sq both ways,
    GQA 5:1 and 8:1 and H = Kh, causal and not; held by flash_bf16_check
    (within tolerance, mean signed error within 0.1 ulp, two launches
    bitwise equal)."""
    gen = torch.Generator(device=dev).manual_seed(sq + 5 * sk + h)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = rnd(2, h, sq, 128), rnd(2, kh, sk, 128), rnd(2, kh, sk, 128)
    assert flash_attention.flash_variant(q.dtype, 128) == "wgmma"
    before = flash_attention.variant_launches["wgmma"]
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    again = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.variant_launches["wgmma"] == before + 2
    k2, v2 = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
    r = flash_attention.flash_bf16_check(
        got, again, flash_attention.flash_attention_ref(
            q.float(), k2.float(), v2.float(), causal=causal),
        flash_attention.flash_bf16_tol(q, k2, v2, causal=causal))
    assert r["ok"], r


def test_flash_wgmma_non_causal_ragged_at_whisper_encoder_shape(dev):
    """whisper's encoder core: non-causal, D=64, S=1500 (no tile multiple;
    the last KV tile masked with no diagonal), on the wgmma kernel, held
    by flash_bf16_check."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(2, 6, 1500, 64, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    assert flash_attention.flash_variant(q.dtype, 64) == "wgmma"
    before = flash_attention.variant_launches["wgmma"]
    got = flash_attention.flash_attention(q, k, v, causal=False)
    again = flash_attention.flash_attention(q, k, v, causal=False)
    assert flash_attention.variant_launches["wgmma"] == before + 2
    r = flash_attention.flash_bf16_check(
        got, again, flash_attention.flash_attention_ref(
            q.float(), k.float(), v.float(), causal=False),
        flash_attention.flash_bf16_tol(q, k, v, causal=False))
    assert r["ok"], r


def _lm_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s)))}
    if cfg.encoder is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    if cfg.vision is not None:
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vision.n_patches, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("name", ["whisper-tiny", "pixtral-12b"])
def test_audio_and_vlm_prefill_on_the_card(dev, name):
    """The reduced whisper and pixtral (fp32) on the card: impl="cuda"
    (flash_attention a layer: whisper's encoder non-causal and decoder
    causal) against impl="torch" on the card and the CPU's prefill, at
    tests/test_torch_lm.py's fp32 tolerance."""
    cfg = get_config(name, reduced=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, dev)
    batch = _lm_batch(cfg, 2, 40, 3)
    want = transformer.prefill(cfg, params, batch, impl="torch")
    scale = max(1.0, float(want.abs().max()))
    n_attn = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)
    for impl in ("cuda", "torch"):
        ops.reset_launch_counts()
        got = transformer.prefill(cfg, on_card, _to(batch, dev), impl=impl)
        assert ops.launch_counts()["flash_attention"] == (
            n_attn if impl == "cuda" else 0)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-5 * scale)


def test_whisper_bf16_prefill_through_wgmma(dev):
    """whisper's serving policy (bf16 compute) at its head dim 64 with a
    ragged encoder (150 frames): every launch on the wgmma kernel, within
    chip_smoke.py's LM_TOL of impl="torch"."""
    cfg = dataclasses.replace(
        get_config("whisper-tiny", reduced=True), head_dim=64,
        encoder=dataclasses.replace(get_config("whisper-tiny").encoder,
                                    n_layers=2, n_frames=150),
        dtype=DTypePolicy(param_dtype="float32", compute_dtype="bfloat16"))
    params = transformer.init_params(cfg, seed=0, device="cuda", max_seq=64)
    batch = _to(_lm_batch(cfg, 2, 64, 4), dev)
    before = dict(flash_attention.variant_launches)
    got = transformer.prefill(cfg, params, batch, impl="cuda")
    assert flash_attention.variant_launches["wgmma"] - before["wgmma"] == \
        cfg.n_layers + cfg.encoder.n_layers
    want = transformer.prefill(cfg, params, batch, impl="torch")
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert rel <= 5e-2 and top1 >= 0.9, (rel, top1)


@pytest.mark.parametrize("name", ["whisper-tiny", "deepseek-v2-lite-16b"])
def test_lm_train_step_on_the_card_matches_the_cpu(dev, name):
    """One make_train_step step of the reduced config (fp32; the MoE
    family with the gather dispatch's autograd pair) on the card against
    the same step on the CPU: loss and grad_norm at rtol 1e-5, no kernel
    launched (training runs the plain path)."""
    from repro_torch.train import optim, step
    cfg = get_config(name, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="gather"))
    params = transformer.init_params(cfg, seed=0, device="cpu", max_seq=32)
    opt = optim.AdamWConfig(lr=1e-3)
    batch = _lm_batch(cfg, 2, 32, 6)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    fn = step.make_train_step(cfg, opt)
    _, _, want = fn(params, optim.init_opt(params, opt), batch)
    on_card = _to(params, dev)
    ops.reset_launch_counts()
    _, _, got = fn(on_card, optim.init_opt(on_card, opt), _to(batch, dev))
    assert not any(ops.launch_counts().values())
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5,
                                   atol=0.0)


# -- the launch analysis -------------------------------------------------------


def test_kernel_notes_equal_their_costs(dev):
    """One launch of each kernel under ``op_analysis.counting`` records its
    ``*_cost`` once, under the kernel's name."""
    from repro_torch.launch import op_analysis
    rng = np.random.default_rng(0)
    c, n, f = 4, 64, 128
    adj, mask = (torch.from_numpy(a).to(dev) for a in _adj(rng, c, n))
    h = torch.randn(c, n, f, device=dev)
    wn, ws = (torch.randn(f, f, device=dev) / f ** 0.5 for _ in range(2))
    b = torch.zeros(f, device=dev)
    e = 256
    src = torch.randint(0, n, (c, e), dtype=torch.int32, device=dev)
    dst = torch.randint(0, n, (c, e), dtype=torch.int32, device=dev)
    w = torch.rand(c, e, device=dev) * (torch.rand(c, e, device=dev) > 0.3)
    z, ss, sd, st = (torch.from_numpy(a).to(dev)
                     for a in _gat_inputs(rng, c, n, f, HEADS))
    q = torch.randn(1, 4, 256, 128, device=dev, dtype=torch.bfloat16)
    kv = torch.randn(1, 2, 256, 128, device=dev, dtype=torch.bfloat16)
    q192 = torch.randn(1, 4, 256, 192, device=dev, dtype=torch.bfloat16)
    kv192 = torch.randn(1, 2, 256, 192, device=dev, dtype=torch.bfloat16)
    cases = [
        ("fused_gnn_layer", lambda: fused_gnn.fused_gnn_layer(
            adj, h, wn, ws, b, mask),
         fused_gnn.fused_cost(adj, h, wn, ws, b, mask)),
        ("scatter_gather_aggregate", lambda: scatter_gather
         .scatter_gather_aggregate(src, dst, w, h),
         scatter_gather.sg_cost(src, dst, w, h)),
        ("gat_attention", lambda: gat_attention.gat_attention(
            z, ss, sd, st, n_heads=HEADS),
         gat_attention.gat_cost(z, ss, sd, st, n_heads=HEADS)),
        ("flash_attention", lambda: flash_attention.flash_attention(
            q, kv, kv, causal=True),
         flash_attention.flash_cost(1, 4, 256, 256, 128, causal=True)),
        ("flash_attention", lambda: flash_attention.flash_attention(
            q192, kv192, kv, causal=True),
         flash_attention.flash_cost(1, 4, 256, 256, 192, causal=True,
                                    v_dim=128)),
    ]
    for name, launch, cost in cases:
        with op_analysis.counting() as s:
            launch()
        torch.cuda.synchronize()
        assert s.kernels == {name: {"launches": 1, "flops": cost["flops"],
                                    "hbm_bytes": cost["hbm_bytes"]}}, name


def test_gnn_cell_count_on_the_card_equals_meta(dev):
    """A measured GNN cell (gat L=3 N=128 at 16 targets, a real batch):
    impl="torch" on the card counts the meta cell's FLOPs and argument
    bytes exactly; impl="cuda" launches the fused and GAT kernels and
    notes them."""
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.cells import build_gnn_cell
    cfg = GNNConfig(kind="gat", n_layers=3, receptive_field=128, f_in=512)
    g = get_graph("flickr", scale=0.05, seed=0)
    with DecoupledEngine(g, dataclasses.replace(cfg, f_in=g.feature_dim),
                         config=ServingConfig(device="cuda", batch_size=16,
                                              mode="dense")) as eng:
        sb = eng.plan(zipf_traffic(g, 16, seed=0)).sb
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    batch = {"feats": t(np.pad(sb.feats, ((0, 0), (0, 0),
                                         (0, 512 - g.feature_dim)))),
             "adj": t(sb.adj), "adj_mean": t(sb.adj_mean),
             "mask": t(sb.mask)}
    params = init_gnn(cfg, seed=0, device="cuda")
    meta = dryrun.run_cell(*build_gnn_cell(cfg, None, C=16), 1)
    card = dryrun.run_cell(*build_gnn_cell(
        cfg, None, C=16, params=params, batch=batch), 1)
    assert card["hlo"]["flops"] == meta["hlo"]["flops"]
    assert card["memory"]["argument_bytes"] == \
        meta["memory"]["argument_bytes"]
    cuda = dryrun.run_cell(*build_gnn_cell(
        cfg, None, C=16, impl="cuda", params=params, batch=batch), 1)
    assert set(cuda["hlo"]["kernels"]) == {"fused_gnn_layer",
                                           "gat_attention"}
    assert op_analysis.active() is None
