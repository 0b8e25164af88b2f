"""The plain reference against the port at smoke size on the CPU: whole runs
of both cells come out correct, and the control (the reference in fp8 in
the program's place) does not."""
import pytest
import torch

from conftest import SEED, SERVE, TRAIN, run_small, small_cell
from harness import compare


def test_train_run_is_correct():
    run = run_small(TRAIN, trace=True)
    assert run.correct, run.rows
    assert run.steps >= 1 and run.tokens == run.steps * 4 * 32


def test_serve_run_is_correct():
    run = run_small(SERVE, trace=True)
    assert run.correct, run.rows
    assert run.failed == 0 and run.tokens > 0


def _train_control(side, seed, **sizes):
    import readings
    w, c, t = small_cell(TRAIN)
    c = dict(c, **sizes, port_overrides=dict(c["port_overrides"], d_model=c["hidden_size"],
                                             d_ff=c["intermediate_size"]))
    rec = readings.train_reading(c, t, seed, side, torch.device("cpu"))
    return compare.judge(rec, compare.limits(w["name"]))


def test_train_control_fails():
    """The reference in fp8 throughout, in the program's place."""
    ok, rows = _train_control("control", SEED)
    assert not ok, rows


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_train_ffn_control_fails(seed):
    """The reference in fp8 in the checked steps' FFN matmuls alone, at 4
    layers (at 2 its FFN gap sits at the card's limit)."""
    ok, rows = _train_control("control_ffn", seed, num_hidden_layers=4)
    assert not ok, rows


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_serve_control_fails(seed):
    """At 12 layers of width 512 and a vocabulary of 4096 (at the smoke size
    the fp8 rounding of two layers stays under the card's limit, and of
    eight on one seed of three)."""
    import readings
    w, c, t = small_cell(SERVE)
    c = dict(c, hidden_size=512, intermediate_size=1024, num_hidden_layers=12, vocab_size=4096,
             port_overrides=dict(c["port_overrides"], d_model=512, d_ff=1024, vocab_size=4096))
    rec = readings.serve_reading(c, t, seed, torch.device("cpu"))
    lim = compare.limits(w["name"])
    assert rec["logit_gap"] <= lim["logit_gap"] < rec["control_gap"], rec
