"""A run with the timed path broken underneath comes out not correct:
each fault a training cell on one chip can have, planted in the port,
with the harness driven as on the card (its look for a card skipped).
Exchanges between chips are not a fault these one-chip cells can have."""
import pytest
import torch

import gala_tpu_torch.lowering.interp as interp
import gala_tpu_torch.train as program_train
from gala_bench import cell as cells


def _unchanged(monkeypatch):
    orig = program_train.make_optimizer

    def frozen(params, lr=0.01, weight_decay=5e-4):
        return orig(params, 0.0, weight_decay)  # steps that leave the state as it was

    monkeypatch.setattr(program_train, "make_optimizer", frozen)


def _half_batch(monkeypatch):
    orig = program_train.masked_cross_entropy

    def half(logits, labels, mask, group=None):
        m = mask.clone()
        m[torch.nonzero(m).flatten()[1::2]] = False  # the mean over the other half
        return orig(logits, labels, m, group)

    monkeypatch.setattr(program_train, "masked_cross_entropy", half)


def _altered(monkeypatch):
    def doubled_row(fn):
        def wrapped(*args):
            out = fn(*args)
            scale = torch.ones((out.shape[0], 1), dtype=out.dtype)
            scale[1] = 2.0
            return out * scale
        return wrapped

    for op in ("spmm", "spmm_ev", "attention_aggregate"):  # every aggregation's output
        monkeypatch.setattr(interp, op, doubled_row(getattr(interp, op)))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered_answer": _altered}


@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("workload", ["gcn2-h32.reddit", "gat2-h32.reddit"])
def test_a_planted_fault_is_not_correct(small_cell, monkeypatch, workload, fault):
    if fault:
        FAULTS[fault](monkeypatch)
    res = cells.run_cell(small_cell(workload), 11, 0.05, False, "cpu")
    assert res["correct"] is (fault is None), res["check"]
