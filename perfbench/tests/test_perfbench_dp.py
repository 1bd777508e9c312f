"""The data-parallel training cell ``ntom-train-dp4`` (``drivers/train_dp.py``)
through the harness's ranks: on the CPU two gloo ranks at a size the CPU
holds, sound and with faults planted in the ranks (the gradients' all-reduce
skipped, a state left unchanged, half the batch); the ``cuda`` case
runs the cell as it stands on four cards over NCCL."""
import json

import pytest
import torch

from perfbench import faults, run
from perfbench.tests.test_perfbench_correct import TRAIN

CELL = "ntom-train-dp4"
TWO = {"config": {**TRAIN["config"], "mesh": {"data": 2, "model": 1}},
       "traffic": TRAIN["traffic"]}


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_train_correctly(trace):
    result = run.launch(CELL, 2 ** 31 + 501 + trace, 1.0, trace, 2, "cpu",
                        TWO, deadline_s=300)
    assert result["correct"], result["checks"]
    assert result["checks"]["replica_gap"]["value"] == 0
    assert result["device"]["count"] == 2
    assert set(result["checks"]) == {"loss_gap", "grad1_gap", "change_gap",
                                     "replica_gap"}
    if trace:
        assert result["metrics"]["allreduce_calls.train"]["value"] == 5
    else:
        assert {"train_env_steps_per_s", "train_iter_ms_p95",
                "setup_s"} <= set(result["metrics"])


def test_skipped_gradient_all_reduce_is_caught():
    result = run.launch(CELL, 2 ** 31 + 503, 0.5, False, 2, "cpu",
                        {**TWO, "driver": "perfbench.tests.dp_fault_driver"},
                        deadline_s=300)
    assert not result["correct"], result["checks"]
    assert result["checks"]["replica_gap"]["value"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS["train"])
def test_planted_faults_are_caught(fault):
    result = run.launch(CELL, 2 ** 31 + 506, 0.5, False, 2, "cpu",
                        {"config": TWO["config"],
                         "traffic": {**TWO["traffic"], "fault": fault},
                         "driver": "perfbench.tests.dp_fault_driver"},
                        deadline_s=300)
    assert not result["correct"], result["checks"]
    assert result["checks"]["replica_gap"]["value"] == 0


def test_a_world_that_is_not_the_mesh_is_refused():
    wrong = {**TWO, "config": {**TWO["config"],
                               "mesh": {"data": 4, "model": 1}}}
    with pytest.raises(run.RankFailure, match="rank 0 exited 1"):
        run.launch(CELL, 2 ** 31 + 504, 0.5, False, 2, "cpu", wrong,
                   deadline_s=300)


@pytest.mark.cuda
def test_the_cell_on_four_cards_over_nccl():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    result = run.launch(CELL, 2 ** 31 + 505, 5.0, True, 4, "cuda",
                        deadline_s=1140)
    print(json.dumps({k: result[k] for k in ("device", "checks")}))
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert result["checks"]["replica_gap"]["value"] == 0
    assert result["metrics"]["allreduce_calls.train"]["value"] == 5
