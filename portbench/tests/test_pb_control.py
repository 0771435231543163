"""On a card: the cell's comparison passes the program (impl="cuda") and
fails its control, the plain reference computed in TF32 put in the
program's place, at a size a test run holds (16 layers at hidden 256,
N=64, C=64 on a 3,000-vertex graph). ``python -m pytest -q -m gpu
portbench/tests``."""
import pytest
import torch

from portbench import run
from portbench.control import control_gap

SMALL = {"config": {"graph": {"num_vertices": 3000}, "receptive_field": 64,
                    "batch_size": 64, "check": {"sample_targets": 32}},
         "traffic": {"fill": 128, "clients": 128}}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["gcn-l16-c512-zipf-closed",
                                      "gat-l16-c512-zipf-closed"])
def test_program_passes_and_control_fails(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = {}

    def also(window, graph, cfg, params, device, seed):
        got["control"] = control_gap(window, graph, cfg, params, device,
                                     seed)
        got["limit"] = cfg["check"]["limits"]["emb_gap"]

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        result, _, checks = run.run_cell(workload, seed, 1.0, False,
                                         overrides=SMALL, also=also)
        assert result["correct"], {c.name: c.value for c in checks}
        assert got["control"] > got["limit"], got
