"""The PyTorch package stands alone and never falls back silently: it
imports with ``jax`` blocked and loads nothing of ``repro``; so do
chip_smoke.py's and the scripts' imports; a CUDA device with no card
raises; the trace, dispatch, precompute and telemetry planes take their
configs and refuse other types, and the transport fields validate as the
reference's (tests/test_config.py); kernels are built from the
repository's sources only."""
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
                "obs.hist", "core.dse", "serve.gnn_server", "launch.serve",
                "obs.flight", "obs.trace", "obs.export", "obs.calib",
                "ckpt.checkpoint", "core.dispatch", "distributed.sharding",
                "store.sharded", "precompute.propagate", "precompute.tier",
                "precompute.config", "precompute.artifact",
                "precompute.manager", "precompute.build", "obs.events",
                "obs.slo", "obs.metrics", "obs.promexp", "obs.regress",
                "distributed.wire", "distributed.rpc",
                "distributed.graph_host", "models.mamba",
                "configs.chatglm3_6b", "configs.deepseek_7b",
                "configs.qwen1_5_4b", "configs.phi3_medium_14b",
                "configs.mamba2_2_7b", "configs.jamba_1_5_large_398b",
                "configs.whisper_tiny", "configs.pixtral_12b",
                "configs.deepseek_v2_lite_16b", "configs.deepseek_v3_671b",
                "train.xent", "train.step", "train.loop", "data.pipeline",
                "distributed.compression", "launch.train")}
        assert slice_modules <= set(MODULES), slice_modules - set(MODULES)
        code = "import repro_torch\n" + "".join(
            f"import {m}\n" for m in MODULES)
        assert _loaded_after(code) == []

    def test_chip_smoke_imports_without_jax_or_repro(self):
        assert _loaded_after("import chip_smoke") == []

    @pytest.mark.parametrize("script", ["gnn_fault_check",
                                        "flash_fault_check",
                                        "flash_design_probe",
                                        "fused_parent_probe",
                                        "fused_design_probe",
                                        "fused_phase_probe",
                                        "gat_phase_probe",
                                        "sg_softmax_probe",
                                        "tier_precision_probe",
                                        "torch_metrics_smoke",
                                        "timing_probe",
                                        "prefill_turns",
                                        "tracer_cost"])
    def test_fault_checks_import_without_jax_or_repro(self, script):
        assert _loaded_after(f"sys.path.insert(0, {str(ROOT / 'scripts')!r})"
                             f"\nimport {script}") == []

    def test_no_source_imports_jax_or_repro(self):
        bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
        for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                  *(ROOT / "scripts").glob("*_fault_check.py"),
                  ROOT / "scripts" / "flash_design_probe.py",
                  *(ROOT / "scripts").glob("fused_*_probe.py"),
                  ROOT / "scripts" / "gat_phase_probe.py",
                  ROOT / "scripts" / "sg_softmax_probe.py",
                  ROOT / "scripts" / "tier_precision_probe.py",
                  ROOT / "scripts" / "torch_metrics_smoke.py",
                  ROOT / "scripts" / "timing_probe.py",
                  ROOT / "scripts" / "prefill_turns.py",
                  ROOT / "scripts" / "tracer_cost.py"]:
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

    @pytest.mark.parametrize("field", ["trace", "dispatch", "precompute",
                                       "telemetry"])
    def test_ported_plane_takes_its_config(self, field):
        from repro_torch.core.dispatch import DispatchConfig
        from repro_torch.obs.metrics import TelemetryConfig
        from repro_torch.obs.trace import TraceConfig
        from repro_torch.precompute import PrecomputeConfig
        conf = {"trace": TraceConfig, "dispatch": DispatchConfig,
                "precompute": PrecomputeConfig,
                "telemetry": TelemetryConfig}[field]()
        sc = ServingConfig(device="cpu", **{field: conf})
        assert getattr(sc, field) is conf
        assert sc.describe()[field] == conf.describe()

    @pytest.mark.parametrize("field", ["trace", "dispatch", "precompute",
                                       "telemetry"])
    def test_ported_plane_refuses_another_type(self, field):
        with pytest.raises(TypeError, match=field):
            ServingConfig(device="cpu", **{field: object()})

    def test_no_plane_is_refused(self):
        from repro_torch.core import config
        assert not hasattr(config, "UNPORTED_PLANES")
        for transport in ("local", "inproc"):
            sc = ServingConfig(device="cpu", transport=transport)
            assert sc.remote == (transport != "local")


class TestTransportConfig:
    """The port's counterparts of tests/test_config.py's transport
    validation."""

    def test_socket_needs_endpoints(self):
        with pytest.raises(ValueError, match="endpoints"):
            ServingConfig(device="cpu", transport="socket")

    def test_endpoints_need_socket(self):
        with pytest.raises(ValueError, match="transport='socket'"):
            ServingConfig(device="cpu", endpoints=("h:1",))
        with pytest.raises(ValueError, match="transport='socket'"):
            ServingConfig(device="cpu", transport="inproc",
                          endpoints=("h:1",))

    def test_endpoints_list_coerced_to_tuple(self):
        c = ServingConfig(device="cpu", transport="socket",
                          endpoints=["a:1", "b:2"])
        assert c.endpoints == ("a:1", "b:2") and c.remote

    @pytest.mark.parametrize("bad", [
        dict(transport="grpc"), dict(routing="random"),
        dict(rpc_timeout_s=0.0), dict(rpc_retries=-1),
        dict(rpc_concurrency=0),
    ])
    def test_bad_rpc_values_rejected(self, bad):
        with pytest.raises(ValueError):
            ServingConfig(device="cpu", **bad)

    def test_describe_covers_transport(self):
        c = ServingConfig(device="cpu", transport="socket",
                          endpoints=("h:1",), routing="affine")
        d = c.describe()
        assert d["transport"] == "socket"
        assert d["endpoints"] == ["h:1"] and d["routing"] == "affine"
        assert "endpoints" not in ServingConfig(device="cpu").describe()
        assert ServingConfig(device="cpu", transport="inproc"
                             ).describe()["endpoints"] == ["inproc"]

    @pytest.mark.parametrize("features,extra", [
        ("resident", {}), ("sharded", {"num_shards": 2})])
    def test_resident_store_raises(self, features, extra):
        """Neither device store raises any longer: the single-device
        resident store and the sharded store are both ported, and the
        config and the factory take them."""
        pol = StorePolicy(features=features, **extra)
        g = get_graph("flickr", scale=0.02, seed=1)
        ServingConfig(device="cpu", store=pol)
        src = build_feature_source(g, pol, 512, "cpu")
        assert src.name == features
        assert src.num_resident == g.num_vertices

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
