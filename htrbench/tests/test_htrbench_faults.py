"""Each fault a cell can have, planted under a run whose look for a chip is
skipped, makes ``correct`` come out false; and each cell's control (the
reference in the precision below the configuration's, in the program's
place) fails one of its numbers. The cells have one chip each, so no
exchange between chips can be left out. The control is read at the cells'
own sizes on the card by ``python3 -m htrbench.probe`` (the ``cuda`` test
below); here at the tiny sizes of ``tiny.py``."""

import pytest
import torch

import htr_vt_torch.cli.serve as serve_cli
import htr_vt_torch.train.step as step_mod
from htrbench import probe
from htrbench.manifest import Bench
from htrbench.run import execute
from htrbench.tests.tiny import CELLS

SEED = 2**31 + 17
SERVE_CELLS = ["iam-int8-serve-512", "iam-serve-512"]


def _run(cell):
    return execute(cell, SEED, 0.05, False, "cpu", CELLS[cell])


def _failed(res):
    return sorted(k for k, c in res["compared"].items() if c["value"] > c["limit"])


def test_sound_runs_are_correct():
    for cell in CELLS:
        assert _run(cell)["correct"], cell


def test_step_that_returns_its_state_unchanged(monkeypatch):
    def unchanged(state, batch):
        batch = step_mod._put(batch, next(state.model.parameters()).device)
        with torch.no_grad():
            loss, _ = step_mod.forward_loss(state, batch)
        return {"loss": loss, "loss_second": loss, "grad_norm": loss}

    monkeypatch.setattr(step_mod, "train_step", unchanged)
    res = _run("iam-train-512")
    assert not res["correct"]
    assert {"change_gap", "grad_gap"} <= set(_failed(res))


def test_half_of_the_batch_left_out(monkeypatch):
    real = step_mod.train_step

    def half(state, batch):
        return real(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(step_mod, "train_step", half)
    res = _run("iam-train-512")
    assert not res["correct"]
    assert "loss_gap" in _failed(res)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_an_answer_altered_where_it_is_produced(monkeypatch, cell):
    monkeypatch.setattr(serve_cli, "eval_step", probe.altered(serve_cli.eval_step))
    res = _run(cell)
    assert not res["correct"]
    assert _failed(res) == ["served_gap"]  # the logits are untouched


def _control_fails(cell, device, seeds):
    c = Bench().cell(cell, None if device.type == "cuda" else CELLS[cell])
    fn = probe.probe_train if c.traffic["driver"] == "train_loop" else probe.probe_serve
    rows = fn(c, [], seeds, device)
    controls = [r for r in rows if r["side"].startswith("control")]
    assert len(controls) == len(seeds)
    for r in controls:
        assert any(v > c.limits[k] for k, v in r.items() if k in c.limits), r


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(cell):
    _control_fails(cell, torch.device("cpu"), [SEED])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_the_card(cell, cuda_device):
    _control_fails(cell, cuda_device, [SEED, SEED + 1, SEED + 2])
