"""A run whose timed path is broken underneath comes out not correct, a
sound one correct; and the control reads as the check must catch it.  All
on the CPU, through the harness's path past its look for a card, with the
sides of portbench/control.py planted in the port."""

import pytest

import control
from harness import cli

SEED = 2**40 + 17
FAULTS = [side for side in control.SIDES if side not in ("program", "control")]
# the number each fault has to move: every fault fails `rejected`; a changed
# answer fails `wrong_outputs` besides
MOVES_OUTPUTS = {"stale_answer", "output_altered"}


def test_sound_run_is_correct(small_cell):
    result, lines = cli.run(small_cell, SEED, 0.1, False, "cpu")
    assert result["correct"], lines
    assert result["checks"] == {"wrong_outputs": {"value": 0, "limit": 0},
                                "rejected": {"value": 0, "limit": 0}}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(small_cell, fault):
    numbers = control.reading(small_cell, SEED, 0.1, fault, device="cpu")
    assert not numbers["correct"]
    assert numbers["rejected"] >= 1
    assert (numbers["wrong_outputs"] >= 1) == (fault in MOVES_OUTPUTS)


def test_faults_are_removed_after_the_run(small_cell):
    import distaff_torch
    from distaff_torch import stark
    from distaff_torch.stark import utils

    before = (distaff_torch.execute, distaff_torch.ProofOptions, stark.prove,
              utils.find_pow_nonce)
    for side in control.SIDES:
        with control.planted(side):
            pass
    assert before == (distaff_torch.execute, distaff_torch.ProofOptions, stark.prove,
                      utils.find_pow_nonce)


@pytest.mark.parametrize("seed", [SEED, 2**33 + 5])
def test_control_is_caught(small_cell, seed):
    assert control.reading(small_cell, seed, 0.1, "program", device="cpu")["rejected"] == 0
    numbers = control.reading(small_cell, seed, 0.1, "control", device="cpu")
    assert not numbers["correct"]
    assert numbers["rejected"] == min(numbers["requests"], 8) >= 1
    assert numbers["first_reason"].endswith("the proof's options are not the stated options")
