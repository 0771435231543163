"""BENCHMARK.json against the files it names, and a cell, a mix or a
metric added by new files and entries alone."""
import importlib
import json
import shutil

from portbench import spec
from portbench.tests.tiny import OVERRIDES

BENCH = spec.benchmark()


def test_every_name_has_its_file():
    here = spec.HERE
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        ref = importlib.import_module(f"portbench.reference."
                                      f"{cfg['reference']}")
        for fn in ("forward", "param_shapes", "layer_flops"):
            assert callable(getattr(ref, fn))
    for w in BENCH["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").exists()
        spec.config(BENCH, w["config"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_every_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(BENCH, w["name"], True)
        for m in spec.metrics_for(BENCH, w["name"], True):
            assert m["moves"] in e2e


def test_a_metric_added_by_a_file_and_an_entry(tmp_path):
    """A throwaway metric: one new reader file and one new entry; the run
    reports it, and no file that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["end_to_end"] = BENCH["end_to_end"] + [{
        "name": "answers_per_s.throwaway", "unit": "1/s",
        "better": "higher", "bound": 0.25, "source": "host_clock"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "metrics" / "answers_per_s.throwaway.py"
     ).write_text("def read(rec):\n"
                  "    return len(rec.window.answered_in_window())"
                  " / rec.window.seconds\n")
    from portbench import run
    result, _, _ = run.run_cell("gcn-l16-c512-zipf-closed", 3, 0.5, False,
                                device="cpu", impl="torch",
                                require_chip=False, overrides=OVERRIDES,
                                root=root)
    got = result["metrics"]["answers_per_s.throwaway"]
    assert got["unit"] == "1/s" and got["value"] > 0
    # on the CPU no kernel runs on a card: the card's metric reads nothing
    assert set(result["metrics"]) == {"setup_s", "answers_per_s.throwaway"}


def test_a_config_a_mix_and_a_snapshot_added_by_files(tmp_path):
    """A throwaway configuration that sets a serving key the harness never
    names (``max_wait_s``), a throwaway mix over part of the graph, and a
    per-layer metric that snapshots the program itself: new files and
    entries alone, and the run passes the key to the port and reports the
    metric."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = spec.config(BENCH, BENCH["configs"][0]["name"])
    pb = root / "portbench"
    (pb / "configs" / "throwaway.json").write_text(json.dumps(
        dict(base, name="throwaway", max_wait_s=0.0125)))
    (pb / "traffic" / "throwaway.json").write_text(json.dumps(
        {"loop": "closed", "clients": 48, "zipf_a": 1.1, "support": 500,
         "fill": 16}))
    (pb / "metrics" / "wait_s.throwaway.py").write_text(
        "def snapshot(system):\n"
        "    return system.server.max_wait_s\n\n\n"
        "def read(rec):\n"
        "    return rec.after['wait_s.throwaway']\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [{
        "name": "throwaway", "source": "https://example.org/throwaway",
        "file": "portbench/configs/throwaway.json", "reduced": [],
        "why": "a test"}]
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "throwaway-cell", "config": "throwaway",
        "traffic": "throwaway", "chips": 1, "why": "a test"}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"]
                                + ["throwaway-cell"]) if "workloads" in m
                           else m for m in BENCH["end_to_end"]]
    bench["per_layer"] = [{
        "name": "wait_s.throwaway", "unit": "s", "better": "lower",
        "source": "program_counter", "layer": "server",
        "moves": "kernel_us_per_target", "workloads": ["throwaway-cell"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from portbench import run
    result, _, _ = run.run_cell("throwaway-cell", 5, 0.5, True,
                                device="cpu", impl="torch",
                                require_chip=False,
                                overrides={"config": OVERRIDES["config"]},
                                root=root)
    assert result["correct"]
    assert result["metrics"]["wait_s.throwaway"]["value"] == 0.0125
