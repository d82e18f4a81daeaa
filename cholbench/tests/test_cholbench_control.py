"""The card's test of the comparison that decides `correct`: the 50^3
cells at their own size, a short window, the solver as its configuration
states it (correct), with the configuration's control switched on, the
TF32 rung one step below the stated IEEE float32, and with a factor that
is never refactored (`faults.stale_factor`); in both of the last the
factor check fails. Marker `cuda`; skips without a card.

    python -m pytest cholbench/tests/test_cholbench_control.py -q
"""

import os
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lapl7_50.refactor", "lapl7_50.solve"])
def test_control_is_not_correct_and_the_solver_is(card, cell):
    from cholbench import control, harness

    seed = 4_100_000_007
    res, checks = harness.run(REPO, cell, seed, 1.0, False, card,
                              time.perf_counter())
    assert res["correct"], checks
    res, checks = harness.run(REPO, cell, seed, 1.0, False, card,
                              time.perf_counter(),
                              prepare=control.apply_control)
    assert not res["correct"]
    assert checks["factor_eta"]["value"] > checks["factor_eta"]["limit"]


@pytest.mark.cuda
def test_a_stale_factor_is_not_correct(card):
    from cholbench import faults, harness

    res, checks = harness.run(REPO, "lapl7_50.refactor", 4_100_000_011, 2.0,
                              False, card, time.perf_counter(),
                              prepare=faults.stale_factor)
    assert not res["correct"]
    assert checks["factor_eta"]["value"] > checks["factor_eta"]["limit"]
