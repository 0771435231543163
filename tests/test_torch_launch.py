"""The port's launch analysis against the reference's at small sizes:
``specs_for`` against ``repro.launch.specs`` (shapes and types; concrete
draws bitwise), ``op_analysis`` on the reference's analytic cases
(``tests/test_hlo_analysis.py``), prefill FLOPs against the reference's
HLO count, the dry-run on fake meshes in subprocesses (a process holds one
fake process group, so none leaks into the test worker), the roofline
over the records, the shard() sites' identity on plain tensors, and the
GNN per-layer oracle and paper grid ported from ``repro.gnn``.

HBM bytes are not compared with the reference's: XLA fuses elementwise
chains into single top-level ops and eager dispatch does not, so the
port's count is an upper bound of the reference's by construction.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import shape_cells as j_shape_cells  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.hlo_analysis import analyze  # noqa: E402
from repro.models.transformer import (init_params as j_init_params,  # noqa: E402
                                      prefill as j_prefill)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.launch import op_analysis, roofline  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import logical_axis_rules  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ShapeConfig("p", 64, 2, "prefill")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _tree(d, prefix=""):
    for k, v in d.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _tree(v, p)
        else:
            yield p, v


def _jtree(d):
    flat = jax.tree_util.tree_flatten_with_path(d)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


# ---------------------------------------------------------------------------
# specs


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_shapes_and_types_equal_the_reference(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for jshape in j_shape_cells(jcfg):
        tshape = ShapeConfig(jshape.name, jshape.seq_len,
                             jshape.global_batch, jshape.kind)
        want = _jtree(jspecs.specs_for(jcfg, jshape))
        got = dict(_tree(tspecs.specs_for(tcfg, tshape)))
        assert sorted(got) == sorted(want), (arch, jshape.name)
        for k, w in want.items():
            g = got[k]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (arch, k)
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), k


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "whisper-tiny",
                                  "pixtral-12b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_concrete_specs_are_the_references_draws(arch, kind):
    jcfg, tcfg = (j_get_config(arch, reduced=True),
                  get_config(arch, reduced=True))
    from repro.configs.base import ShapeConfig as JShape
    js = JShape(kind, 64, 4, kind)
    ts = ShapeConfig(kind, 64, 4, kind)
    want = _jtree(jspecs.specs_for(jcfg, js, mode="random", seed=7))
    got = dict(_tree(tspecs.specs_for(tcfg, ts, mode="random", seed=7,
                                      device="cpu")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 \
            else got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    if kind == "decode":
        assert got["pos"].dim() == 0 and got["pos"].dtype == torch.int32


# ---------------------------------------------------------------------------
# op_analysis on the reference's analytic cases


@pytest.mark.parametrize("L", [2, 5, 9])
def test_loop_of_matmuls_counts_exactly(L):
    M = K = N = 32
    w = torch.randn(L, K, N)
    with op_analysis.counting() as s:
        h = torch.randn(M, K)
        for i in range(L):
            h = h @ w[i]
    assert s.flops == 2.0 * L * M * K * N
    assert s.flops_by_dtype == {"float32": s.flops}


def test_one_matmul_equals_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta", dtype=torch.float32)
    with op_analysis.counting() as s:
        a @ b
    with FlopCounterMode(display=False) as f:
        a @ b
    assert s.flops == f.get_total_flops() == 2 * 64 * 128 * 32
    # the result and both operands, each once
    assert s.hbm_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_note_kernel_only_inside_a_summary():
    op_analysis.note_kernel("k", 10.0, 20.0, torch.bfloat16)  # no summary
    with op_analysis.counting() as s:
        op_analysis.note_kernel("k", 10.0, 20.0, torch.bfloat16)
        op_analysis.note_kernel("k", 10.0, 20.0, torch.bfloat16)
    assert s.kernels == {"k": {"launches": 2, "flops": 20.0,
                               "hbm_bytes": 40.0}}
    assert s.flops_by_dtype == {"bfloat16": 20.0}
    assert op_analysis.active() is None


def test_peak_live_bytes_frees_with_the_tensors():
    with op_analysis.counting() as s:
        a = torch.ones(1024)                       # 4 KiB live
        b = a * 2                                  # 8 KiB live
        del a, b
        c = torch.ones(256)                        # 1 KiB live
    assert s.peak_live_bytes == 8192
    assert s.live_bytes == 1024
    del c


FAKE_MESH_SCRIPT = r"""
import json
import torch
from torch.distributed.tensor import (Partial, Replicate, Shard,
                                      distribute_tensor, DTensor)
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_test_mesh, start_fake_group
start_fake_group(8)
mesh = make_test_mesh(2, 4)
out = {}
x = distribute_tensor(torch.empty(8, 32, device="meta"), mesh,
                      [Replicate(), Shard(1)])
with op_analysis.counting() as s:
    x.redistribute(mesh, [Replicate(), Replicate()])    # group of 4
    for _ in range(7):
        p = DTensor.from_local(torch.empty(8, 8, device="meta"), mesh,
                               [Replicate(), Partial()], run_check=False)
        p.redistribute(mesh, [Replicate(), Replicate()])
out["collectives"] = s.to_json()
a = torch.empty(8, 64, device="meta")
b = torch.empty(64, 32, device="meta")
for name, pa, pb in [("replicated", [Replicate(), Replicate()],
                      [Replicate(), Replicate()]),
                     ("batch", [Replicate(), Shard(0)],
                      [Replicate(), Replicate()]),
                     ("contraction", [Replicate(), Shard(1)],
                      [Replicate(), Shard(0)])]:
    da, db = (distribute_tensor(a, mesh, pa), distribute_tensor(b, mesh, pb))
    with op_analysis.counting() as s:
        r = da @ db
    out[name] = [s.flops, [p.is_partial() for p in r.placements]]
prop = DTensor._op_dispatcher.sharding_propagator
wrapped = lambda: "_propagate_tensor_meta_non_cached" in vars(prop)
out["wrapped"] = [wrapped()]
with op_analysis.counting():
    torch.ones(4) * 2
    out["wrapped"].append(wrapped())
    x * 2
    out["wrapped"].append(wrapped())
out["wrapped"].append(wrapped())
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_mesh_counts():
    r = subprocess.run([sys.executable, "-c", FAKE_MESH_SCRIPT], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[-1][len("RESULT"):])


def test_collectives_on_a_fake_mesh(fake_mesh_counts):
    """The canned module of the reference's test: an all-gather to 8x32
    fp32 over a group of 4, and 7 all-reduces of 8x8 fp32 over a group of
    4, with the 3/4 and 2 * 3/4 ring factors."""
    c = fake_mesh_counts["collectives"]
    assert c["per_collective"]["all-gather"] == 8 * 32 * 4
    assert c["per_collective"]["all-reduce"] == 7 * 8 * 8 * 4
    assert c["collective_count"] == {"all-gather": 1, "all-reduce": 7}
    expect = (8 * 32 * 4) * 3 / 4 + 7 * (8 * 8 * 4) * 2 * 3 / 4
    np.testing.assert_allclose(c["collective_link_bytes"], expect)
    assert c["link_bytes_by_group"] == {"4": expect}


def test_sharded_matmul_flops_per_device(fake_mesh_counts):
    whole = 2.0 * 8 * 64 * 32
    assert fake_mesh_counts["replicated"][0] == whole
    assert fake_mesh_counts["batch"][0] == whole / 4
    flops, partial = fake_mesh_counts["contraction"]
    assert flops == whole / 4
    assert partial == [False, True]     # summed across "model" later


def test_only_dtensor_counts_wrap_propagation(fake_mesh_counts):
    """DTensor's propagation methods are wrapped from a count's first
    DTensor op to the end of its block: a count of plain tensors leaves
    torch's internals as they are."""
    assert fake_mesh_counts["wrapped"] == [False, False, True, False]


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO count


def _ref_prefill_flops(arch):
    jc = j_get_config(arch, reduced=True)
    params = jax.eval_shape(lambda: j_init_params(
        jc, jax.random.PRNGKey(0), max_seq=SMALL.seq_len))
    B, S = SMALL.global_batch, SMALL.seq_len
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if jc.family == "audio":
        batch["frames"] = jax.ShapeDtypeStruct(
            (B, jc.encoder.n_frames, jc.d_model), jnp.float32)
    if jc.family == "vlm":
        batch["patch_embeds"] = jax.ShapeDtypeStruct(
            (B, jc.vision.n_patches, jc.d_model), jnp.float32)
    txt = jax.jit(lambda p, b: j_prefill(jc, p, b)).lower(
        params, batch).compile().as_text()
    return analyze(txt).flops


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flops_agree_with_the_reference(arch):
    """Every arch's reduced prefill at B=2, S=64 on one device: the port's
    dispatched matmul FLOPs against the reference's dot FLOPs of the
    compiled HLO, within 1 %. They agree exactly: both packages dispatch
    MoE by sorting with the experts as one batched matmul, and the port's
    SSD state step (an ``addcmul``, elementwise, uncounted) matches an
    elementwise update in the reference's HLO, so mamba2 and Jamba are
    held too."""
    want = _ref_prefill_flops(arch)
    fn, args = build_cell(get_config(arch, reduced=True), SMALL, None)
    with op_analysis.counting() as s:
        fn(*args)
    print(f"{arch}: port {s.flops:.6g}, reference {want:.6g}")
    assert abs(s.flops - want) <= 0.01 * want


# ---------------------------------------------------------------------------
# the dry-run on fake meshes


DENSE = [a for a in ARCHS if get_config(a).family == "dense"]


def _dryrun(mesh, out, *runs):
    code = ("import sys\nfrom repro_torch.launch import dryrun\n"
            "rc = 0\n"
            + "".join(f"rc |= dryrun.main({list(r) + ['--test-mesh', mesh, '--reduced', '--out', out]!r})\n"
                      for r in runs)
            + "sys.exit(rc)\n")
    return subprocess.Popen([sys.executable, "-c", code], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


_REFERENCE_SHARDED = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, jax
from jax.sharding import AxisType
from repro.configs.base import SHAPES
from repro.configs.registry import ARCHS, get_config
from repro.launch.cells import build_cell
from repro.launch.hlo_analysis import analyze
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in ARCHS:
    for name in ("prefill_32k", "decode_32k"):
        shp = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=8)
        fn, args, ins, outs, don = build_cell(get_config(arch, reduced=True),
                                              shp, mesh)
        with mesh:
            txt = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                          donate_argnums=don).lower(*args).compile().as_text()
        out[f"{arch}__{name}"] = analyze(txt, n_devices=8).to_json()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    """The reference's own cells, reduced, on a (2, 4) mesh of 8 forced
    host devices, compiled in a subprocess (the device count is fixed at
    jax's first use) while the port's dry-run runs beside it: per-device
    HLO counts by cell name."""
    path = str(tmp_path_factory.mktemp("reference") / "counts.json")
    env = dict(_env(), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_SHARDED,
                             path], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, path
    if proc.poll() is None:          # no test of this module waited for it
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory, reference_sharded):
    """Both test meshes, in four subprocesses at once (a 3-d mesh makes
    DTensor's sharding propagation several times slower, so its archs are
    split in two): every arch's prefill and decode, the GNN cells of each
    kind at 16 targets on both meshes, and the dense family's train cells
    on the 2x4 mesh."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    pd = ["--shape", "prefill_32k,decode_32k"]
    gnn = ["--gnn-only", "--gnn-batch", "16"]
    archs = list(ARCHS)
    half = len(archs) // 2
    groups = [
        ("2,4", [["--arch", "all"] + pd, gnn]),
        ("2,4", [["--arch", ",".join(DENSE), "--shape", "train_4k"]]),
        ("2,2,2", [["--arch", ",".join(archs[:half])] + pd, gnn]),
        ("2,2,2", [["--arch", ",".join(archs[half:])] + pd]),
    ]
    procs = [(m, _dryrun(m, out, *runs)) for m, runs in groups]
    logs = [p.communicate(timeout=900)[0] for _, p in procs]
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            recs[name[:-5]] = json.load(f)
    return recs, logs, out


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_every_reduced_prefill_and_decode_cell_is_ok(dryrun_records, mesh):
    recs, logs, _ = dryrun_records
    for arch in ARCHS:
        for shape in ("prefill_32k", "decode_32k"):
            name = f"{arch}__{shape}__{mesh}"
            assert name in recs, (name, logs)
            r = recs[name]
            assert r["ok"], (name, r.get("error"), r.get("traceback"))
            assert r["hlo"]["flops"] > 0
            assert r["n_devices"] == 8


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_gnn_cells_of_each_kind_are_ok(dryrun_records, mesh):
    recs, _, _ = dryrun_records
    names = [n for n in recs if n.endswith(f"__serve__{mesh}")]
    assert {n.split("-")[0] for n in names} == {"gcn", "sage", "gat"}
    for name in names:
        r = recs[name]
        assert r["ok"], (name, r.get("error"), r.get("traceback"))


def test_dense_train_cells_are_ok(dryrun_records):
    recs, _, _ = dryrun_records
    for arch in DENSE:
        r = recs[f"{arch}__train_4k__2x4"]
        assert r["ok"], (arch, r.get("error"), r.get("traceback"))
        # forward, rematerialized forward and backward at the prefill
        # cell's tokens: more than twice its FLOPs a device
        pre = recs[f"{arch}__prefill_32k__2x4"]["hlo"]["flops"]
        assert r["hlo"]["flops"] > 2 * pre
        assert r["hlo"]["collective_bytes"] > 0


@pytest.mark.parametrize("mesh", [((2, 4), ("data", "model")),
                                  ((2, 2, 2), ("pod", "data", "model"))])
def test_argument_bytes_are_the_local_shards(dryrun_records, mesh):
    """A record's argument bytes are the sum of rank 0's shards of the
    cell's arguments, as the rules place them (computed here from the
    specs, without a process group)."""
    from repro_torch.distributed.sharding import (batch_spec, cache_pspecs,
                                                  param_pspecs)
    import types
    shape, names = mesh
    m = types.SimpleNamespace(shape=dict(zip(names, shape)),
                              axis_names=names)
    kind = "x".join(map(str, shape))
    recs, _, _ = dryrun_records

    def local(t, spec):
        dims = list(t.shape)
        for d, a in enumerate(spec):
            for ax in ((a,) if isinstance(a, str) else (a or ())):
                dims[d] = -(-dims[d] // m.shape[ax])  # rank 0: ceil
        return int(np.prod(dims)) * t.element_size()

    def tree_bytes(tree, specs):
        return sum(local(t, s) for (_, t), (_, s) in
                   zip(_tree(tree), _tree(specs)))

    for arch in ("qwen1.5-4b", "deepseek-v2-lite-16b", "mamba2-2.7b"):
        cfg = get_config(arch, reduced=True)
        shp = ShapeConfig("decode_32k", 64, 8, "decode")
        p = T.init_params(cfg, device="meta", max_seq=64)
        cache = T.init_cache(cfg, 8, 64, device="meta")
        bs = batch_spec(8, m)
        want = (tree_bytes(p, param_pspecs(cfg, p, m))
                + tree_bytes(cache, cache_pspecs(cfg, cache, m, 8))
                + local(torch.empty(8, 1, dtype=torch.int32), bs + (None,))
                + 4)                                        # pos
        rec = recs[f"{arch}__{shp.name}__{kind}"]
        assert rec["memory"]["argument_bytes"] == want, arch
        # the cache is updated in place: aliased, not new memory
        assert rec["memory"]["alias_bytes"] == \
            tree_bytes(cache, cache_pspecs(cfg, cache, m, 8))


# GSPMD chooses by cost where the port's rule is fixed: in v3's decode (8
# tokens) it splits the summed dim of MLA's down-projections (w_dkv, w_kr,
# whole on the model axis) over that axis; the port runs them whole
_FLOPS_DIFFER = {("deepseek-v3-671b", "decode_32k"): 1.0733}
# the collectives agree where no dim splits unevenly and nothing is routed
_LINKS_AGREE = ("deepseek-7b", "qwen1.5-4b", "whisper-tiny")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_cells_agree_with_the_reference(dryrun_records,
                                                reference_sharded, arch):
    """The port's per-device counts of a reduced prefill and decode on the
    fake (2, 4) mesh against the reference's HLO counts of the same cells
    compiled for 8 host devices. FLOPs within 1 %, except v3's decode
    (the port counts 1.0733 times the reference's: ``_FLOPS_DIFFER``).
    Collective link bytes are equal for the three archs of
    ``_LINKS_AGREE``. The others are printed: GSPMD regroups an uneven
    GQA split (KV heads 2 on a model axis of 4) into collectives over
    pairs of devices, and dispatches MoE tokens and SSM states with
    all-to-alls and permutes, where the port gathers."""
    proc, path = reference_sharded
    log = proc.communicate(timeout=900)[0]
    assert proc.returncode == 0, log[-3000:]
    with open(path) as f:
        ref = json.load(f)
    recs, _, _ = dryrun_records
    for shape in ("prefill_32k", "decode_32k"):
        got = recs[f"{arch}__{shape}__2x4"]["hlo"]
        want = ref[f"{arch}__{shape}"]
        ratio = got["flops"] / want["flops"]
        links = (got["collective_link_bytes"], want["collective_link_bytes"])
        print(f"{arch} {shape}: flops {got['flops']:.6g} / "
              f"{want['flops']:.6g} = {ratio:.4f}; link bytes port "
              f"{links[0]:.6g}, reference {links[1]:.6g}")
        assert ratio == pytest.approx(
            _FLOPS_DIFFER.get((arch, shape), 1.0), abs=0.01)
        if arch in _LINKS_AGREE:
            assert links[0] == links[1]


_FLIP_GAP = """
import sys
import pytest, torch
from torch.distributed.tensor import DTensor
from repro_torch.launch import dryrun
out, archs, cut = sys.argv[1], sys.argv[2], sys.argv[3] == "cut"
prop = DTensor._op_dispatcher.sharding_propagator
flip = torch.ops.aten.flip.default
tables = [getattr(prop, n) for n in dir(prop)
          if isinstance(getattr(prop, n, None), dict)]
with pytest.MonkeyPatch.context() as mp:
    if cut:
        for table in tables:
            if flip in table:
                mp.delitem(table, flip)
        assert not any(flip in t for t in tables)
        prop.propagate_op_sharding.cache_clear()
    sys.exit(dryrun.main(["--arch", archs, "--shape", "train_4k",
                          "--test-mesh", "2,4", "--reduced", "--out", out]))
"""
SSD_ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def flip_gap_records(tmp_path_factory):
    """The SSD archs' reduced train cells on the (2, 4) fake mesh, run
    whole and with ``aten.flip`` taken out of DTensor's sharding
    propagator (torch 2.11 registers no strategy for it; 2.13 does), each
    in its own subprocess (a second run of a cell in one process counts
    other HBM bytes than the first): records by (run, arch)."""
    root = tmp_path_factory.mktemp("flip_gap")
    procs = {run: subprocess.Popen(
        [sys.executable, "-c", _FLIP_GAP, str(root / run),
         ",".join(SSD_ARCHS), run], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for run in ("whole", "cut")}
    log = "".join(p.communicate(timeout=600)[0][-3000:]
                  for p in procs.values())
    recs = {}
    for run in procs:
        for arch in SSD_ARCHS:
            path = root / run / f"{arch}__train_4k__2x4.json"
            if path.exists():
                recs[run, arch] = json.loads(path.read_text())
    return recs, log


@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_ssd_train_cell_needs_no_flip_strategy(flip_gap_records, arch):
    """SSD's cumulative sum runs on local shards forward and backward
    (``models.common.cumsum``), so its backward's ``flip`` never reaches
    DTensor: the train cell is ``ok`` without a strategy for it, and every
    count equals the whole run's."""
    recs, log = flip_gap_records
    whole, cut = recs.get(("whole", arch)), recs.get(("cut", arch))
    assert whole is not None and cut is not None, log
    assert whole["ok"], (whole.get("error"), whole.get("traceback"))
    assert cut["ok"], (cut.get("error"), cut.get("traceback"))
    assert cut["hlo"]["flops"] == whole["hlo"]["flops"] > 0
    assert cut["hlo"] == whole["hlo"]
    assert cut["memory"] == whole["memory"]


_GAT_ACT_BYTES = """
import json, sys
import torch
import torch.nn.functional as TF
from repro_torch.core import program
from repro_torch.launch import op_analysis
from repro_torch.launch.cells import build_gnn_cell
from repro_torch.launch.dryrun import GNN_CELLS
from repro_torch.launch.mesh import make_mesh, start_fake_group
start_fake_group(256)
mesh = make_mesh((16, 16), ("data", "model"))
if sys.argv[1] == "cut":
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    ops = (torch.ops.aten.leaky_relu.default, torch.ops.aten.elu.default)
    for n in dir(prop):
        table = getattr(prop, n, None)
        if isinstance(table, dict):
            for op in ops:
                table.pop(op, None)
    prop.propagate_op_sharding.cache_clear()
cell = {c.display: c for c in GNN_CELLS}["gat-L3-N128"]
fn, args = build_gnn_cell(cell, mesh)
now = [None]
sites = {"leaky_relu": {"counted": 0.0, "tensors": 0.0, "calls": 0},
         "elu": {"counted": 0.0, "tensors": 0.0, "calls": 0}}
dispatch = op_analysis._Counter.__torch_dispatch__


def counted(self, func, types, args=(), kwargs=None):
    before = self.s.hbm_bytes
    out = dispatch(self, func, types, args, kwargs)
    if now[0] is not None:
        sites[now[0]]["counted"] += self.s.hbm_bytes - before
    return out


def watched(name, real):
    def act(x, *a, **kw):
        now[0] = name
        try:
            y = real(x, *a, **kw)
        finally:
            now[0] = None
        local = lambda t: t._local_tensor.numel() * t.element_size()
        sites[name]["tensors"] += local(x) + local(y)
        sites[name]["calls"] += 1
        return y
    return act


op_analysis._Counter.__torch_dispatch__ = counted
TF.leaky_relu = watched("leaky_relu", TF.leaky_relu)
program.ACTS["elu"] = watched("elu", program.ACTS["elu"])
with op_analysis.counting() as s:
    fn(*args)
print(json.dumps({"sites": sites, "hbm_bytes": s.hbm_bytes,
                  "torch": torch.__version__}))
"""


@pytest.mark.parametrize("strategies", ["registered", "cut"])
def test_gat_activation_bytes_are_their_tensors(strategies):
    """The GAT survey cell (gat-L3-N128, 4096 targets on the 16x16 fake
    mesh): the HBM bytes the op analysis counts inside each leaky ReLU
    (``core/program.py``, the dense attention scores) and each ELU (the
    layer's activation) are that call's input and output, each once, at
    the local shard's size; three layers, three calls each. "cut" takes
    the two ops' strategies out of DTensor's sharding propagator, as torch
    2.11 has none: DTensor then traces their decompositions on global
    ``meta`` stand-ins, which the analysis must not count (it did: 410
    times the cell's bytes on 2.11)."""
    r = subprocess.run([sys.executable, "-c", _GAT_ACT_BYTES, strategies],
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    C, heads, N, F = 4096 // 256, 4, 128, 256
    want = {"leaky_relu": 2 * C * heads * N * N * 4,      # e [C,h,N,N]
            "elu": 2 * C * N * F * 4}                     # [C,N,F]
    for name, per_call in want.items():
        site = got["sites"][name]
        assert site["calls"] == 3, (name, site)
        assert site["tensors"] == 3 * per_call, (name, site)
        assert site["counted"] == site["tensors"], (name, site, got["torch"])


def test_roofline_reads_the_records(dryrun_records):
    _, _, out = dryrun_records
    rows = roofline.load_rows(out)
    assert len(rows) == len(os.listdir(out))
    md = roofline.render_md(rows)
    assert "| qwen1.5-4b | prefill_32k | 2x4* |" in md
    assert md.endswith(roofline.SHARDED_NOTE)
    assert "fits 80G" in md
    for r in rows:
        assert r.t_bound > 0 and r.fit
        assert r.dominant in ("compute", "memory", "collective")
    sharded = [r for r in rows if r.t_collective > 0]
    assert sharded, "no cell moved bytes across the mesh"


def test_roofline_terms_use_the_cards_peaks():
    rec = {"ok": True, "arch": "x", "shape": "serve", "mesh": "m",
           "n_devices": 1, "memory": {"peak_bytes_est": 81 * 10 ** 9},
           "hlo": {"flops": 989e12 + 67e12, "hbm_bytes": 3.35e12,
                   "flops_by_dtype": {"bfloat16": 989e12,
                                      "float32": 67e12},
                   "link_bytes_by_group": {"8": 450e9, "16": 50e9},
                   "collective_link_bytes": 500e9}}
    r = roofline.row_from_record(rec)
    assert r.t_compute == pytest.approx(2.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(2.0)
    assert not r.fit


# ---------------------------------------------------------------------------
# the shard() sites change no number on plain tensors


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b"])
def test_prefill_bitwise_with_and_without_rules(arch):
    cfg = get_config(arch, reduced=True)
    p = T.init_params(cfg, seed=1, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64), dtype=np.int32))
    plain = T.prefill(cfg, p, {"tokens": tok}, impl="torch")
    rules = {"batch": ("data",), "heads": "model", "kv_heads": "model",
             "ff": "model", "vocab": "model", "experts": "model",
             "expert_ff": None}
    with logical_axis_rules(rules):
        ruled = T.prefill(cfg, p, {"tokens": tok}, impl="torch")
    assert torch.equal(plain, ruled)


# ---------------------------------------------------------------------------
# the GNN gaps: per-layer oracle and paper grid


def test_paper_model_grid_equals_the_reference():
    from repro.gnn.model import paper_model_grid as jgrid
    from repro_torch.gnn.model import paper_model_grid
    want = [dataclasses.asdict(c) for c in jgrid(f_in=512, num_classes=7)]
    got = [dataclasses.asdict(c) for c in paper_model_grid(512, 7)]
    assert got == want and len(got) == 36


GN = 32


@pytest.fixture(scope="module")
def gnn_batch():
    from repro.core.config import ServingConfig as JConfig
    from repro.core.engine import DecoupledEngine as JEngine
    from repro.core.subgraph import build_batch
    from repro.gnn.model import GNNConfig as JGNN
    from repro.graphs.synthetic import get_graph
    g = get_graph("flickr", scale=0.02, seed=1)
    sb = build_batch(g, [1, 5, 9, 13], GN, e_pad=GN * (GN - 1),
                     num_threads=1)
    eng = JEngine(g, JGNN(kind="gcn", n_layers=3, receptive_field=GN,
                          f_in=g.feature_dim),
                  config=JConfig(batch_size=4, mode="sg",
                                 e_pad=GN * (GN - 1)))
    d = eng.device_batch(sb)
    eng.close()
    d.setdefault("adj", sb.adj)
    d.setdefault("adj_mean", sb.adj_mean)
    return g, {k: np.asarray(v) for k, v in d.items()}


def _assert_close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("mode", ["dense", "sg"])
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin", "gat"])
def test_layer_apply_matches_the_reference(gnn_batch, kind, mode):
    from repro.gnn import layers as jl
    from repro.gnn.model import GNNConfig as JGNN, init_gnn as j_init
    from repro_torch.gnn import layers as tl
    from repro_torch.gnn.model import params_from_jax
    g, nb = gnn_batch
    jcfg = JGNN(kind=kind, n_layers=3, receptive_field=GN,
                f_in=g.feature_dim)
    jp = j_init(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jh, th = jb["feats"], tb["feats"]
    layers = [(jp["layer0"], tp["layer0"])] + [
        (jax.tree_util.tree_map(lambda x, i=i: x[i], jp["layers"]),
         {k: v[i] for k, v in tp["layers"].items()}) for i in range(2)]
    for jlp, tlp in layers:                   # layer by layer
        jh = jl.LAYER_APPLY[kind](jlp, jh, jb, mode)
        th_next = tl.LAYER_APPLY[kind](tlp, th, tb, mode)
        _assert_close(th_next, jh)
        th = torch.from_numpy(np.array(jh))   # the reference's input next
    assert set(tl.LAYER_INITS) == set(jl.LAYER_INITS)


@pytest.mark.parametrize("mode", ["dense", "sg"])
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin", "gat"])
def test_program_matches_the_ported_layer_oracle(gnn_batch, kind, mode):
    """As tests/test_program.py holds the reference's lowered program to
    its LAYER_APPLY chain: the port's program (impl="torch") against the
    port's per-layer oracle, the same weights and batch."""
    from repro_torch.gnn import layers as tl
    from repro_torch.gnn.model import GNNConfig, gnn_forward, init_gnn
    g, nb = gnn_batch
    cfg = GNNConfig(kind=kind, n_layers=3, receptive_field=GN,
                    f_in=g.feature_dim)
    p = init_gnn(cfg, seed=5, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in nb.items()}
    emb, _ = gnn_forward(cfg, p, b, mode=mode, impl="torch")
    h = tl.LAYER_APPLY[kind](p["layer0"], b["feats"], b, mode)
    for i in range(cfg.n_layers - 1):
        h = tl.LAYER_APPLY[kind]({k: v[i] for k, v in p["layers"].items()},
                                 h, b, mode)
    want = tl.readout(h, b["mask"], cfg.readout)
    _assert_close(emb, want.numpy())
