"""The PyTorch package stands alone and never falls back silently: it
imports with ``jax`` blocked and loads nothing of ``repro``; so do
chip_smoke.py's and the fault-check scripts' imports; a CUDA device with no card raises; every
ServingConfig field of a plane not ported yet raises; kernels are built
from the repository's sources only."""
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.config import ServingConfig  # noqa: E402
from repro_torch.gnn.model import (  # noqa: E402
    GNNConfig, init_gnn, params_from_jax as gnn_params_from_jax)
from repro_torch.graphs.synthetic import get_graph  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.store import StorePolicy, build_feature_source  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def _loaded_after(code: str) -> dict:
    """Run ``code`` in a fresh interpreter with ``jax`` blocked and return
    the modules of jax/repro it left loaded."""
    probe = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"{code}\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and (m == 'jax' or m.startswith('jax.')\n"
        "                  or m == 'repro' or m.startswith('repro.')))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


class TestImportIsolation:
    def test_every_module_imports_without_jax_or_repro(self):
        slice_modules = {
            f"repro_torch.{m}" for m in (
                "graphs.csr", "graphs.synthetic", "core.ini",
                "core.subgraph", "store.policy", "store.nbr_cache",
                "store.feature_store", "kernels.ref", "kernels.fused_gnn",
                "kernels.scatter_gather", "kernels.gat_attention",
                "kernels.ops", "kernels.build", "gnn.layers", "core.ack",
                "core.program", "gnn.lowering", "gnn.model", "core.config",
                "core.report_schema", "core.scheduler", "core.batchplan",
                "core.engine", "devices", "configs.base", "configs.registry",
                "kernels.flash_attention", "models.common", "models.rope",
                "models.mlp", "models.attention", "models.transformer",
                "obs.hist", "core.dse", "serve.gnn_server", "launch.serve")}
        assert slice_modules <= set(MODULES), slice_modules - set(MODULES)
        code = "import repro_torch\n" + "".join(
            f"import {m}\n" for m in MODULES)
        assert _loaded_after(code) == []

    def test_chip_smoke_imports_without_jax_or_repro(self):
        assert _loaded_after("import chip_smoke") == []

    @pytest.mark.parametrize("script", ["gnn_fault_check",
                                        "flash_fault_check",
                                        "gat_phase_probe"])
    def test_fault_checks_import_without_jax_or_repro(self, script):
        assert _loaded_after(f"sys.path.insert(0, {str(ROOT / 'scripts')!r})"
                             f"\nimport {script}") == []

    def test_no_source_imports_jax_or_repro(self):
        bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
        for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                  *(ROOT / "scripts").glob("*_fault_check.py"),
                  ROOT / "scripts" / "gat_phase_probe.py"]:
            for line in p.read_text().splitlines():
                assert not bad.match(line), (p, line)


class TestNoSilentFallback:
    def test_cuda_device_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the no-card path does "
                        "not apply")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingConfig()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingConfig(device="cuda", impl="torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_gnn(GNNConfig(kind="gcn", n_layers=1, f_in=8))

    def test_defaults_are_cuda(self):
        fields = ServingConfig.__dataclass_fields__
        assert fields["device"].default == "cuda"
        assert fields["impl"].default == "cuda"
        for fn, arg in ((init_gnn, "device"), (gnn_params_from_jax, "device"),
                        (transformer.init_params, "device"),
                        (transformer.init_cache, "device"),
                        (transformer.params_from_jax, "device"),
                        (transformer.prefill, "impl"),
                        (transformer.backbone, "impl")):
            default = inspect.signature(fn).parameters[arg].default
            assert default == "cuda", (fn.__qualname__, arg, default)

    @pytest.mark.parametrize("field", ["trace", "telemetry", "dispatch",
                                       "precompute"])
    def test_unported_plane_raises(self, field):
        with pytest.raises(NotImplementedError, match=field):
            ServingConfig(device="cpu", **{field: object()})

    @pytest.mark.parametrize("transport", ["inproc", "socket"])
    def test_remote_transport_raises(self, transport):
        with pytest.raises(NotImplementedError, match="transport"):
            ServingConfig(device="cpu", transport=transport)

    @pytest.mark.parametrize("features,extra", [
        ("resident", {}), ("sharded", {"num_shards": 2})])
    def test_resident_store_raises(self, features, extra):
        """The sharded store is not ported and raises, naming itself; the
        single-device resident store is ported and is accepted."""
        pol = StorePolicy(features=features, **extra)
        g = get_graph("flickr", scale=0.02, seed=1)
        if features == "resident":
            ServingConfig(device="cpu", store=pol)
            assert build_feature_source(g, pol, 512, "cpu").name == \
                "resident"
            return
        with pytest.raises(NotImplementedError, match="features"):
            ServingConfig(device="cpu", store=pol)
        with pytest.raises(NotImplementedError, match="features"):
            build_feature_source(g, pol, 512, "cpu")

    def test_bad_impl_rejected(self):
        with pytest.raises(ValueError, match="impl"):
            ServingConfig(device="cpu", impl="pallas")


class TestBuild:
    def test_sources_in_repo(self):
        for k in build.KERNELS:
            assert (build.CSRC / f"{k}.cu").is_file()
        assert build.BUILD_DIR == ROOT / "build" / "repro_torch_kernels"
        assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS

    def test_library_path_keyed_by_source_hash(self):
        paths = {build.library_path(k) for k in build.KERNELS}
        assert len(paths) == len(build.KERNELS)
        for k in build.KERNELS:
            stem = build.library_path(k).name
            assert stem.startswith(f"{k}-") and stem.endswith(".so")

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        monkeypatch.setattr(build, "Path", lambda p: tmp_path / "absent")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc_path()
