"""The import boundary: nothing the harness loads is JAX or the JAX
package (top-level names compared whole: ``repro_torch`` is not
``repro``), the reference imports nothing of the port, and a run without
a card, or without the program, prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys

import torch

from portbench import spec
from portbench.run import FORBIDDEN

HARNESS = spec.HERE


def imported(path):
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_harness_file_imports_jax_or_the_jax_package():
    files = [p for p in HARNESS.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        assert not imported(p) & set(FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in (HARNESS / "reference").rglob("*.py"):
        assert not imported(p) & {"repro_torch", *FORBIDDEN}, p


def test_whole_names_are_compared(monkeypatch):
    from portbench.run import forbidden_modules
    base = forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_probe.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "repro.probe", sys)
    assert "repro" in forbidden_modules()


def test_a_whole_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'src'];"
            "from portbench.tests.tiny import run_tiny;"
            "from portbench.run import forbidden_modules;"
            "run_tiny('gat-l16-c512-zipf-closed', seconds=0.3);"
            "print('LOADED', forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert "LOADED []" in out.stdout, out.stderr[-2000:]


def run_py(root):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gcn-l16-c512-zipf-closed", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": ""})


def no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert not isinstance(json.loads(line), dict)
        except ValueError:
            pass


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        return                      # the card is there: nothing to show
    out = run_py(spec.ROOT)
    assert out.returncode == 2
    no_result(out)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HARNESS, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0
    no_result(out)
