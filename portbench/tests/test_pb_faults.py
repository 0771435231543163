"""The comparison fails the faults a served cell can have. A tiny run on
the CPU (the look for a card skipped) with the timed path broken
underneath must come out not correct:
- a step that returns its state unchanged (every aggregation returns its
  input);
- half of the batch left out (the second half of a batch's slots served
  the first half's answers);
- an answer altered where it is produced (one slot a batch, by a
  thousandth of the batch's largest value)."""
import pytest
import torch

from portbench.tests.tiny import run_tiny
from repro_torch.core import program
from repro_torch.core.engine import DecoupledEngine

GCN = "gcn-l16-c512-zipf-closed"


def half_batch(run_device):
    def broken(self, batch):
        emb = run_device(self, batch).clone()
        half = emb.shape[0] // 2
        emb[half:] = emb[:emb.shape[0] - half]
        return emb
    return broken


def altered(run_device):
    def broken(self, batch):
        emb = run_device(self, batch).clone()
        emb[0] += 1e-3 * emb.abs().max()
        return emb
    return broken


@pytest.mark.parametrize("loop", ["closed", "open"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(monkeypatch, loop, fault):
    if fault == "unchanged":
        monkeypatch.setattr(program, "agg_dense", lambda adj, h: h)
    else:
        wrap = half_batch if fault == "half_batch" else altered
        monkeypatch.setattr(DecoupledEngine, "run_device",
                            wrap(DecoupledEngine.run_device))
    result, _, checks = run_tiny(GCN, loop=loop)
    assert not result["correct"], {c.name: c.value for c in checks}


def test_gat_fault_is_not_correct(monkeypatch):
    monkeypatch.setattr(DecoupledEngine, "run_device",
                        altered(DecoupledEngine.run_device))
    result, _, _ = run_tiny("gat-l16-c512-zipf-closed")
    assert not result["correct"]


def test_sound_runs_are_correct():
    assert torch.get_default_dtype() == torch.float32
    for loop in ("closed", "open"):
        assert run_tiny(GCN, loop=loop)[0]["correct"]
