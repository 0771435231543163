"""The port's sharding rules against the reference's, spec for spec: for
every arch of the registry at full width, on the single-pod 16x16 and the
multi-pod 2x16x16 meshes, ``param_pspecs``, ``cache_pspecs``,
``zero1_pspecs``, ``activation_rules`` and ``batch_spec``. The rules read
only a mesh's axis names and sizes, so both packages get a stand-in mesh
object (no devices, no process group); the reference's trees come from
``jax.eval_shape``, the port's are ``meta``. Also ``placements`` (a spec
as DTensor placements) and the shard() hook's identity without rules or
on plain tensors."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.transformer import (init_cache as j_init_cache,  # noqa: E402
                                      init_params as j_init_params)
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import (logical_axis_rules,  # noqa: E402
                                       logical_to_pspec, shard)
from repro_torch.train.optim import AdamWConfig, init_opt  # noqa: E402

MESHES = {"single": ({"data": 16, "model": 16}, ("data", "model")),
          "multi": ({"pod": 2, "data": 16, "model": 16},
                    ("pod", "data", "model"))}
CACHE_B, CACHE_S = 128, 32768     # decode_32k's cache


def _mesh(kind):
    shape, names = MESHES[kind]
    return types.SimpleNamespace(shape=shape, axis_names=names)


def _ref_flat(tree):
    """{path: spec tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(v) for path, v in flat}


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


@pytest.fixture(scope="module")
def trees():
    """Per arch: (reference params, port params, reference cache, port
    cache), shapes only."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        jp = jax.eval_shape(lambda c=jcfg: j_init_params(
            c, jax.random.PRNGKey(0), max_seq=4096))
        tp = T.init_params(tcfg, device="meta", max_seq=4096)
        jc = j_init_cache(jcfg, CACHE_B, CACHE_S, mode="specs")
        tc = T.init_cache(tcfg, CACHE_B, CACHE_S, device="meta")
        out[arch] = (jcfg, tcfg, jp, tp, jc, tc)
    return out


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_cache_zero1_specs_equal_the_reference(trees, arch,
                                                     mesh_kind):
    jcfg, tcfg, jp, tp, jc, tc = trees[arch]
    mesh = _mesh(mesh_kind)
    jps = jsh.param_pspecs(jcfg, jp, mesh)
    tps = tsh.param_pspecs(tcfg, tp, mesh)
    assert _port_flat(tps) == _ref_flat(jps)
    assert _port_flat(tsh.zero1_pspecs(tps, tp, mesh)) == \
        _ref_flat(jsh.zero1_pspecs(jps, jp, mesh))
    assert _port_flat(tsh.cache_pspecs(tcfg, tc, mesh, CACHE_B)) == \
        _ref_flat(jsh.cache_pspecs(jcfg, jc, mesh, CACHE_B))
    assert tsh.activation_rules(tcfg, mesh) == \
        jsh.activation_rules(jcfg, mesh)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_batch_spec_equals_the_reference(mesh_kind):
    mesh = _mesh(mesh_kind)
    for b in (1, 2, 8, 16, 24, 32, 128, 256, 4096):
        assert tsh.batch_spec(b, mesh) == tuple(jsh.batch_spec(b, mesh)), b


@pytest.mark.parametrize("arch", ARCHS)
def test_unmeshed_param_specs_and_cache_tree(trees, arch):
    """Without a mesh the specs are unsanitized, as the reference's; the
    port's meta cache is the reference's ``mode="specs"`` tree."""
    jcfg, tcfg, jp, tp, jc, tc = trees[arch]
    assert _port_flat(tsh.param_pspecs(tcfg, tp)) == \
        _ref_flat(jsh.param_pspecs(jcfg, jp))
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    tflat = {k: v for k, v in _leaves(tc)}
    assert len(jflat) == len(tflat)
    for path, leaf in jflat:
        key = "/".join(str(k.key) for k in path)
        t = tflat[key]
        assert tuple(t.shape) == tuple(leaf.shape), key
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), key
        assert t.device.type == "meta"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def test_meta_trees_match_the_reference_and_hold_no_memory(trees):
    for arch, (jcfg, tcfg, jp, tp, jc, tc) in trees.items():
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        tflat = dict(_leaves(tp))
        assert len(jflat) == len(tflat), arch
        for path, leaf in jflat:
            key = "/".join(str(k.key) for k in path)
            t = tflat[key]
            assert tuple(t.shape) == tuple(leaf.shape), (arch, key)
            assert str(t.dtype).replace("torch.", "") == str(leaf.dtype)
            assert t.device.type == "meta"


def test_meta_is_refused_by_other_entry_points():
    cfg = get_config("qwen1.5-4b", reduced=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.params_from_jax({"a": np.zeros(2)}, device="meta")
    p = T.init_params(cfg, device="meta")
    opt = init_opt(p, AdamWConfig())
    assert opt.m["embed"].device.type == "meta"


def test_cpu_draws_unchanged_by_the_meta_path():
    """The generator path is untouched by the meta one: the first draw of
    ``init_params`` (the embedding) is the generator's normals times 0.02,
    and two draws are bitwise equal."""
    cfg = get_config("mamba2-2.7b", reduced=True)
    a = T.init_params(cfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    want = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen) * 0.02
    assert torch.equal(a["embed"], want)
    b = T.init_params(cfg, seed=5, device="cpu")
    for (k, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), k


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsh.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert tsh.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="named twice"):
        tsh.placements(("model", "model"), mesh)


def test_shard_hook_is_identity_without_rules_or_dtensors():
    x = torch.randn(2, 3, 4)
    assert shard(x, ("batch", None, "heads")) is x
    rules = {"batch": ("data",), "heads": "model"}
    with logical_axis_rules(rules):
        assert shard(x, ("batch", None, "heads")) is x
        assert logical_to_pspec(("batch", None, "heads")) == \
            (("data",), None, "model")
    assert logical_to_pspec(("batch",)) == (None,)
