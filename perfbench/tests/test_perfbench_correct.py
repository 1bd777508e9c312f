"""A run at a size the CPU holds, past the harness's look for a card: sound
it comes out correct, and with each fault the cell can have planted in
the program (``perfbench/faults.py``) it does not."""
import pytest

from perfbench import faults, run

SEED = 2 ** 31 + 4321
SMALL = {"config": {"horizon": 8},
         "traffic": {"batch": 16, "warm_calls": 1, "sample_within": 4,
                     "profile_steps": 2}}
# the trainers' loss is small at a few steps; at these sizes a sound run
# reads ~3e-7, as at the cells' own (PERF.md)
TRAIN = {"config": {"horizon": 24},
         "traffic": {"batch": 64, "checked_iterations": 2,
                     "profile_steps": 1}}
CELLS = {"ntom-train": ("train", TRAIN),
         "ntom-collect": ("collect", SMALL), "ntom-eval": ("evaluate", SMALL)}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell, trace):
    result = run.run_cell(cell, SEED, 0.2, trace, "cpu", CELLS[cell][1])
    assert list(result)[-1] == "checks"
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in faults.FAULTS[CELLS[c][0]]])
def test_a_planted_fault_is_caught(cell, fault):
    kind, size = CELLS[cell]
    with faults.plant(kind, fault):
        result = run.run_cell(cell, SEED, 0.2, False, "cpu", size)
    assert not result["correct"], result["checks"]


def test_a_learner_the_reference_does_not_follow_is_refused():
    size = {"config": {**TRAIN["config"], "learner_dtype": "bfloat16"},
            "traffic": TRAIN["traffic"]}
    with pytest.raises(ValueError, match="learner_dtype"):
        run.run_cell("ntom-train", SEED, 0.2, False, "cpu", size)
