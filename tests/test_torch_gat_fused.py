"""GAT's attention step as one launch: ``gat_attention_layer`` (the slab
kernel's fused form) and the program's grouped AttentionScore + dense
AttentionSoftmax step.

On the CPU:
(a) the wrapper's CPU path is bitwise the two steps it replaces as the
    program runs them under impl="cuda" on CPU tensors (the score einsums,
    ``_struct``, ``gat_attention_ref``, the bias, activation and row mask),
    on inputs with empty, dense and all -inf rows, non-finite z, and adj
    entries that are negative, zero, NaN and in padded columns;
(b) a GAT program compiled with the grouped step gives bitwise the two-step
    program's embeddings (on CPU tensors the step runs the two steps), and ``compile_steps`` groups only an
    AttentionScore directly followed by a dense AttentionSoftmax over the
    same register and heads, under impl="cuda"; the measured dispatch finds
    the grouped step's cell;
(c) ``gat_slab_model.layer_model``, the fused kernel's arithmetic in numpy,
    matches the plain composition, and each fault planted in what the fused
    form adds disagrees with it.

On the card (``-m gpu``): the fused launch against its plain PyTorch
composition (``gat_attention_layer_ref``) and against the unfused chain on
the card within ``test_torch_gat.py``'s TOL with NaN and inf in the same
places, its structure bit for bit ``_struct(...) > 0``, the program's
fallback at a head of 128 columns and for bf16 z, and ``fused_launches``
with a grouped program's embeddings against the two-step program's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import program as tprog  # noqa: E402
from repro_torch.gnn.model import GNNConfig, init_gnn  # noqa: E402
from repro_torch.kernels import gat_attention, ops  # noqa: E402
from repro_torch.obs.calib import (CalibrationTable, op_label,  # noqa: E402
                                   run_instrumented)

from gat_slab_model import LAYER_FAULTS, layer_model  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)            # test_torch_gat.py's
SHAPES = [(1, 16, 8, 2), (2, 32, 64, 4), (2, 64, 128, 1), (1, 48, 96, 3)]
ACT_BIAS = [("elu", True), ("elu", False), ("relu", True), ("none", False)]


def _layer_inputs(rng, c, n, f, heads, density=0.2, poison=False):
    """z, a_src, a_dst, adj, mask and b (numpy float32) with the plain
    form's edge rows made through the layer: row 1 empty (no in-edges, and
    its own column padded), row 2 dense, row 3's structural scores all -inf
    (z[3] at -3e38 in column 1 of each head, where a_dst is 2: its s_dst
    overflows), row 4 dense and all -inf alike; row 6 holds a negative, a
    zero, a NaN entry and a negative diagonal (not structural), row 8 a NaN
    diagonal (structural), and subgraph 0 pads its last n // 8 columns
    while adj still has entries there. ``poison``: test_torch_gat.py's
    inf and NaN in z, and an inf in column 0 of row 8, where a_src < 0 gives
    a -inf score and so a weight of exactly 0 into row 7."""
    fh = f // heads
    z = rng.standard_normal((c, n, f)).astype(np.float32)
    a_src = rng.standard_normal((heads, fh)).astype(np.float32)
    a_dst = rng.standard_normal((heads, fh)).astype(np.float32)
    adj = rng.uniform(size=(c, n, n)).astype(np.float32)
    adj *= rng.uniform(size=(c, n, n)) < density
    mask = np.ones((c, n), np.float32)
    mask[0, n - n // 8:] = 0.0
    mask[:, 1] = 0.0
    adj[:, 1, :] = 0.0
    adj[:, 2, :] = adj[:, 4, :] = 1.0
    if fh > 1:
        a_dst[:, 1], a_src[:, 1] = 2.0, 0.25
        for h in range(heads):
            z[:, 3, h * fh + 1] = z[:, 4, h * fh + 1] = -3e38
    adj[:, 6, 0], adj[:, 6, 5], adj[:, 6, 6] = -0.5, 0.0, -0.25
    adj[:, 6, 7] = adj[:, 8, 8] = np.nan
    b = rng.standard_normal(f).astype(np.float32)
    if poison:
        z[0, 5, 1] = np.inf
        z[-1, n - 1, f - 1] = np.nan
        z[0, 6, f // 2] = -np.inf
        a_src[:, 0] = -0.5
        adj[0, 7, 8] = 0.5
        z[0, 8, 0] = np.inf
    return z, a_src, a_dst, adj, mask, b


def _two_steps(z, a_src, a_dst, adj, mask, b, heads, act):
    """The program's AttentionScore and dense AttentionSoftmax steps under
    impl="cuda", run apart; returns the layer's output."""
    score = tprog.AttentionScore(n_heads=heads)
    soft = tprog.AttentionSoftmax(n_heads=heads, act=act, mode="dense",
                                  b="b" if b is not None else None)
    p = {"a_src": a_src, "a_dst": a_dst, "b": b}
    regs = {"z": z}
    batch = {"adj_mean": adj, "mask": mask}
    tprog._step_attention_score(score)(p, regs, batch)
    tprog._step_attention_softmax(soft, "cuda")(p, regs, batch)
    return regs["h"]


def _fused(z, a_src, a_dst, adj, mask, b, heads, act):
    return gat_attention.gat_attention_layer(z, a_src, a_dst, adj, mask, b,
                                             n_heads=heads, act=act)


def _bitwise(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _same(got, want):
    """NaN in the same places, infinities equal, the rest within TOL."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


# -- (a) the wrapper's CPU path -----------------------------------------------


@pytest.mark.parametrize("act,bias", ACT_BIAS)
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("c,n,f,heads", SHAPES)
def test_cpu_path_is_the_two_steps_bitwise(c, n, f, heads, poison, act,
                                           bias):
    rng = np.random.default_rng(n + heads)
    args = [torch.from_numpy(a)
            for a in _layer_inputs(rng, c, n, f, heads, poison=poison)]
    if not bias:
        args[-1] = None
    with np.errstate(invalid="ignore", over="ignore"):
        got = _fused(*args, heads, act)
        want = _two_steps(*args, heads, act)
    _bitwise(got, want)
    assert bool(torch.isnan(want).any()) == poison
    if not poison:
        assert (want[:, 1] == 0).all()           # empty and padded


def test_cpu_path_counts_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in _layer_inputs(rng, 1, 16, 8, 2)]
    _fused(*args, 2, "elu")
    assert gat_attention.launches == gat_attention.fused_launches == 0
    assert gat_attention.fused_fallbacks == 0


def test_wrapper_refuses_bad_inputs():
    rng = np.random.default_rng(1)
    z, a_src, a_dst, adj, mask, b = [
        torch.from_numpy(a) for a in _layer_inputs(rng, 1, 16, 8, 2)]
    with pytest.raises(ValueError, match="act"):
        _fused(z, a_src, a_dst, adj, mask, b, 2, "gelu")
    with pytest.raises(ValueError, match="a_src"):
        _fused(z, a_src[:1], a_dst, adj, mask, b, 2, "elu")
    with pytest.raises(ValueError, match="mask"):
        _fused(z, a_src, a_dst, adj, mask[:, :8], b, 2, "elu")
    with pytest.raises(ValueError, match="divisible"):
        _fused(z, a_src, a_dst, adj, mask, b, 3, "elu")


@pytest.mark.parametrize("n,f,heads,dtype,fits", [
    (256, 256, 4, torch.float32, True),      # the served shape
    (200, 256, 8, torch.float32, True),      # head width 32
    (256, 512, 4, torch.float32, False),     # head width 128: two slabs
    (256, 256, 4, torch.bfloat16, False),
    (320, 256, 4, torch.float32, False),     # N > 256
    (254, 256, 4, torch.float32, False),     # N not a multiple of 4
])
def test_layer_fits(n, f, heads, dtype, fits):
    z = torch.zeros(1, n, f, dtype=dtype)
    a = torch.zeros(heads, f // heads, dtype=dtype)
    adj, mask = torch.zeros(1, n, n), torch.ones(1, n)
    b = torch.zeros(f, dtype=dtype)
    assert gat_attention.layer_fits(z, a, a, adj, mask, b,
                                    n_heads=heads) == fits


# -- (b) the program's grouped step -------------------------------------------


N_PROG = 32


def _gat_program(force="dense", n_layers=3, heads=4, f_in=24):
    cfg = GNNConfig(kind="gat", n_layers=n_layers, receptive_field=N_PROG,
                    f_in=f_in, f_hidden=64, n_heads=heads)
    prog, _ = tprog.lower_and_specialize(cfg, force=force)
    return cfg, prog


def _prog_batch(rng, c=3, f_in=24):
    _, _, _, adj, mask, _ = _layer_inputs(rng, c, N_PROG, 8, 2)
    adj = np.nan_to_num(np.abs(adj))
    feats = rng.standard_normal((c, N_PROG, f_in)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in
            (("feats", feats), ("adj_mean", adj), ("mask", mask))}


def test_grouped_program_is_the_two_step_program_bitwise(monkeypatch):
    cfg, prog = _gat_program()
    params = init_gnn(cfg, 5, device="cpu")
    batch = _prog_batch(np.random.default_rng(2))
    labels = [op_label(ops_) for ops_, _ in
              tprog.compile_steps(prog.inner, "cuda")]
    assert labels == ["Transform", tprog.ATTENTION_GROUP]
    emb, h = tprog.execute(prog, params, batch, impl="cuda")
    monkeypatch.setattr(tprog, "_attention_pair", lambda seq, i: False)
    assert [op_label(ops_) for ops_, _ in
            tprog.compile_steps(prog.inner, "cuda")] == [
        "Transform", "AttentionScore", "AttentionSoftmax"]
    emb2, h2 = tprog.execute(prog, params, batch, impl="cuda")
    _bitwise(emb, emb2)
    _bitwise(h, h2)


def test_grouped_step_keeps_the_attention_marks():
    cfg, prog = _gat_program(n_layers=2)
    params = init_gnn(cfg, 5, device="cpu")
    batch = _prog_batch(np.random.default_rng(3))
    marks = []
    tprog.execute(prog, params, batch, impl="cuda", mark=marks.append)
    layer = ["attention.begin", "attention.end", "layer"]
    assert marks == layer * 2 + ["tail"]


S, SM = tprog.AttentionScore, tprog.AttentionSoftmax
R = tprog.Residual


@pytest.mark.parametrize("seq,impl,grouped", [
    ((S(n_heads=4), SM(n_heads=4, mode="dense")), "cuda", True),
    ((S(n_heads=4), SM(n_heads=4, mode="dense")), "torch", False),
    ((S(n_heads=4), SM(n_heads=4, mode="sg")), "cuda", False),
    ((S(n_heads=4, src="z2"), SM(n_heads=4, mode="dense")), "cuda", False),
    ((S(n_heads=2), SM(n_heads=4, mode="dense")), "cuda", False),
    ((S(n_heads=4), R(src="h_in", into="z"), SM(n_heads=4, mode="dense")),
     "cuda", False),
    ((SM(n_heads=4, mode="dense"), S(n_heads=4)), "cuda", False),
])
def test_compile_steps_groups_only_the_pair(seq, impl, grouped):
    labels = [op_label(o) for o, _ in tprog.compile_steps(seq, impl)]
    assert (tprog.ATTENTION_GROUP in labels) == grouped
    assert len(labels) == len(seq) - grouped


def _measured_attention(cfg, cells):
    """specialize's decisions for the AttentionSoftmax sites from a table
    holding ``cells`` ({(label, impl/mode): p50 s}) at bucket 7."""
    t = CalibrationTable()
    for (label, mode), sec in cells.items():
        t.record(label, mode, 7, sec)
    _, dec = tprog.specialize(tprog.lower(cfg), n=N_PROG, f_in=cfg.f_in,
                              f_hidden=cfg.f_hidden, measured=t,
                              measured_impl="cuda", measured_bucket=7)
    att = [d for d in dec if d.op.startswith("AttentionSoftmax")]
    assert att
    return att


def test_measured_specialize_finds_the_grouped_cell():
    """Under impl="cuda" the dense softmax is timed as the grouped step:
    specialize's measured lookup of AttentionSoftmax reads that cell, and
    the sg side's scores, timed as their own step."""
    cfg, prog = _gat_program()
    table = CalibrationTable()
    params = init_gnn(cfg, 5, device="cpu")
    batch = _prog_batch(np.random.default_rng(4))
    run_instrumented(prog, params, batch, "cuda", table)
    assert {r["op"] for r in table.rows()} == {"Transform",
                                              tprog.ATTENTION_GROUP}
    for mode, sg_cost in (("dense", 1e3), ("sg", 1e-9)):
        att = _measured_attention(cfg, {
            (tprog.ATTENTION_GROUP, "cuda/dense"): 1e-3,
            ("AttentionSoftmax", "cuda/sg"): sg_cost,
            ("AttentionScore", "cuda/-"): 1e-9})
        assert all(d.mode == mode and d.reason.startswith("measured")
                   for d in att)


@pytest.mark.parametrize("score,mode", [(4e-4, "dense"), (2e-4, "sg")])
def test_measured_specialize_charges_the_sg_side_its_scores(score, mode):
    """The grouped cell holds the scores: the sg softmax alone (0.7 ms) is
    under it (1 ms), but the sg softmax and its scores may not be. The
    lookup compares the two steps' totals."""
    cfg, _ = _gat_program()
    att = _measured_attention(cfg, {
        (tprog.ATTENTION_GROUP, "cuda/dense"): 1e-3,
        ("AttentionSoftmax", "cuda/sg"): 7e-4,
        ("AttentionScore", "cuda/-"): score})
    assert all(d.mode == mode and d.reason.startswith("measured")
               for d in att)


def test_measured_specialize_without_the_sg_scores_uses_the_model():
    """With the grouped cell but no cell for the sg side's scores the two
    sides cannot be compared: the FLOP model decides, as with any cold
    cell."""
    cfg, _ = _gat_program()
    att = _measured_attention(cfg, {
        (tprog.ATTENTION_GROUP, "cuda/dense"): 1e-3,
        ("AttentionSoftmax", "cuda/sg"): 1e-9})
    assert not any(d.reason.startswith("measured") for d in att)


# -- (c) the numpy model of the fused form ------------------------------------


def _plain(args, heads, act):
    t = [torch.from_numpy(a) for a in args]
    return gat_attention.gat_attention_layer_ref(*t, n_heads=heads,
                                                 act=act).numpy()


@pytest.mark.parametrize("act", ["elu", "relu", "none"])
@pytest.mark.parametrize("c,n,f,heads", SHAPES)
def test_layer_model_matches_the_plain_composition(c, n, f, heads, act):
    rng = np.random.default_rng(3 * n + heads)
    args = _layer_inputs(rng, c, n, f, heads, poison=True)
    with np.errstate(invalid="ignore", over="ignore"):
        want = _plain(args, heads, act)
        _same(layer_model(*args, heads, act), want)
    assert np.isnan(want).any()


@pytest.mark.parametrize("fault", LAYER_FAULTS)
def test_layer_model_faults_disagree(fault):
    c, n, f, heads = SHAPES[1]
    rng = np.random.default_rng(7)
    args = _layer_inputs(rng, c, n, f, heads, poison=True)
    with np.errstate(invalid="ignore", over="ignore"):
        want = _plain(args, heads, "elu")
        got = layer_model(*args, heads, "elu", fault=fault)
    with pytest.raises(AssertionError):
        _same(got, want)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


CARD_SHAPES = [(c, n, fh, "elu", True) for c in (8, 512) for n in (200, 256)
               for fh in (32, 64)] + [
    (8, 256, 64, act, bias) for act, bias in ACT_BIAS[1:]]


@pytest.mark.gpu
@pytest.mark.parametrize("c,n,fh,act,bias", CARD_SHAPES)
def test_fused_launch_matches_the_unfused_chain(dev, c, n, fh, act, bias):
    heads = 4
    rng = np.random.default_rng(c + n + fh)
    args = _on(dev, _layer_inputs(rng, c, n, heads * fh, heads,
                                  density=16 / n, poison=c == 8))
    if not bias:
        args[-1] = None
    before = gat_attention.fused_launches
    got = _fused(*args, heads, act)
    again = _fused(*args, heads, act)
    want = _two_steps(*args, heads, act)
    plain = gat_attention.gat_attention_layer_ref(*args, n_heads=heads,
                                                  act=act)
    torch.cuda.synchronize()
    assert gat_attention.fused_launches == before + 2
    _bitwise(got, again)
    _same(got.cpu(), plain.cpu())
    _same(got.cpu(), want.cpu())


@pytest.mark.gpu
def test_fused_structure_is_the_plain_structure_bitwise(dev):
    """With a_src = a_dst = 0 every structural weight of row i is 1 / n_i
    and z = I reads it back: out[i, j] > 0 exactly where ``_struct > 0``.
    adj holds signed zeros, subnormals, infinities and NaN, on the diagonal
    too, and padded columns."""
    c, n, heads = 4, 256, 4
    rng = np.random.default_rng(9)
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, np.inf, -np.inf, np.nan,
                     0.5, -0.5], np.float32)
    adj = rng.choice(vals, size=(c, n, n), p=[.3, .1, .05, .05, .05, .05,
                                              .1, .2, .1]).astype(np.float32)
    mask = np.ones((c, n), np.float32)
    mask[1, 200:] = 0.0
    z = np.broadcast_to(np.eye(n, dtype=np.float32), (c, n, n)).copy()
    a = np.zeros((heads, n // heads), np.float32)
    t = _on(dev, (z, a, a, adj, mask))
    got = _fused(*t, None, heads, "none")
    want = tprog._struct({"adj_mean": t[3]}, t[4], n, t[0]) > 0
    rows = t[4] > 0
    assert torch.equal((got > 0)[rows], want[rows])
    assert want[rows].any(-1).all()


def _outcome(fn):
    """fn()'s result, or its exception's type and message."""
    try:
        return fn()
    except (TypeError, ValueError, RuntimeError) as e:
        return type(e), str(e)


@pytest.mark.gpu
@pytest.mark.parametrize("fh,dtype", [(128, torch.float32),
                                      (64, torch.bfloat16)])
def test_program_falls_back_and_counts(dev, fh, dtype):
    """Shapes the fused kernel does not take run the two steps as they run
    apart, with the same outcome (in bf16 the score terms come out bf16,
    which ``gat_attention`` refuses, in both), each such step counted."""
    heads, c, n = 4, 8, 256
    rng = np.random.default_rng(fh)
    args = _on(dev, _layer_inputs(rng, c, n, heads * fh, heads,
                                  density=16 / n))
    z, a_src, a_dst, adj, mask, b = args
    z, a_src, a_dst, b = (x.to(dtype) for x in (z, a_src, a_dst, b))
    seq = (tprog.AttentionScore(n_heads=heads),
           tprog.AttentionSoftmax(n_heads=heads, mode="dense"))
    [(_, step)] = tprog.compile_steps(seq, "cuda")
    p = {"a_src": a_src, "a_dst": a_dst, "b": b}
    batch = {"adj_mean": adj, "mask": mask}
    regs = {"z": z}
    ops.reset_launch_counts()
    got = _outcome(lambda: step(p, regs, batch) or regs["h"])
    assert gat_attention.fused_fallbacks == 1
    assert gat_attention.fused_launches == 0
    want = _outcome(lambda: _two_steps(z, a_src, a_dst, adj, mask, b,
                                       heads, "elu"))
    if isinstance(want, tuple):
        assert got == want
    else:
        assert gat_attention.launches == 2
        _bitwise(got, want)


@pytest.mark.gpu
def test_fused_launches_count_the_fused_steps(dev, monkeypatch):
    """A 4-layer GAT program launches the fused form once a layer, and its
    embeddings are the two-step program's within TOL."""
    cfg, prog = _gat_program(n_layers=4)
    params = init_gnn(cfg, 5, device="cuda")
    batch = {k: v.to(dev) for k, v in
             _prog_batch(np.random.default_rng(6)).items()}
    ops.reset_launch_counts()
    emb, _ = tprog.execute(prog, params, batch, impl="cuda")
    torch.cuda.synchronize()
    assert gat_attention.fused_launches == gat_attention.launches == 4
    assert gat_attention.variant_launches["slab"] == 4
    assert gat_attention.fused_fallbacks == 0
    assert torch.isfinite(emb).all()
    monkeypatch.setattr(tprog, "_attention_pair", lambda seq, i: False)
    want, _ = tprog.execute(prog, params, batch, impl="cuda")
    assert gat_attention.fused_launches == 4
    _same(emb.cpu(), want.cpu())
