"""A run with the timed path broken underneath comes out not correct.

Each test drives the harness on the CPU (the look for a card skipped) at
a small size with one of `faults.py`'s faults planted in the port: a step
that returns its state unchanged; half of the sources left out of the
gravity sum and the rest counted double (the mean over the rest); the
kicked particles' accelerations reversed where the solver produces them;
the drift skipped; and, where the cell has them, the PM force left out and
the Yukawa law taken as Newton.  The cells run on one card, so no
exchange between chips exists to leave out."""

import pytest

import faults
import smallcells

SEED = 2 ** 31 + 404
CASES = [(name, fault) for name in ("galaxy.tree", "lcdm_gas.full")
         for fault in ("unchanged_state", "half_the_sources",
                       "altered_forces", "drift_skipped")] \
    + [("lcdm_gas.full", "pm_left_out"),
       ("lcdm_gas.full", "yukawa_as_newton")]


@pytest.mark.parametrize("name, fault", CASES)
def test_a_broken_step_is_not_correct(name, fault):
    cell = smallcells.small_cell(name)
    with faults.FAULTS[fault](cell):
        res = smallcells.run_small(name, SEED, cell=cell)
    assert res["correct"] is False
    failed = [k for k, v in res["check"].items() if v["value"] > v["limit"]]
    assert failed, res["check"]
