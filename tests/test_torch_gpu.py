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
to bf16), with grouped KV heads, and a reduced dense LM's prefill through
it against the plain path. The scatter-gather's bucket kernel past the
sort kernel's 16-bit edge indices (E = 65,537) and at N=1024 with the
Flickr-sized graph's 74,496 edge slots; the three GNN kernels in bf16
within one bf16 ulp of their plain versions' fp32 results; and a
multi-model server answering through the kernels. Skipped where no CUDA device is
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
    assert fused_gnn.variant_launches == {
        "tf32x3": before["tf32x3"] + 3, "cuda_core": before["cuda_core"]}
    torch.testing.assert_close(
        got, fused_gnn.fused_gnn_layer_ref(*args, act="elu"), **TOL)
    assert torch.equal(got, again) and torch.equal(got, wide)


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
    before = fused_gnn.variant_launches["cuda_core"]
    got = fused_gnn.fused_gnn_layer(*args)
    assert fused_gnn.variant_launches["cuda_core"] == before + 1
    want = fused_gnn.fused_gnn_layer_ref(
        *[a.float() if a is not None else None for a in args])
    _bf16_held(got, want)


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
