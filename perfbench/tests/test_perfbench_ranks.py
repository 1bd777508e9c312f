"""A cell on several ranks: the launcher, the lockstep and the merge.

On the CPU two ranks join a gloo group through the program's
``parallel/mesh.py`` and all-reduce at every step (``ranks_driver.py``,
reached through ``launch``'s override); the ``cuda`` cases run four ranks
on four cards over NCCL."""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
LIMITS = {"step_spread": 0, "sum_gap": 0}


def _override(**traffic):
    return {"driver": "perfbench.tests.ranks_driver",
            "traffic": {"batch": 64, "warm_calls": 2, "profile_steps": 3,
                        "limits": LIMITS, **traffic}}


def _ranks_left(seed):
    """Processes of this machine that run a rank of a run seeded ``seed``
    from this checkout."""
    mark = f"perfbench.run\0--workload\0ntom-collect\0--seed\0{seed}\0"
    found = []
    for d in Path("/proc").iterdir():
        try:
            if (d.name.isdigit() and mark in (d / "cmdline").read_text()
                    and (d / "cwd").resolve() == ROOT):
                found.append(int(d.name))
        except OSError:
            pass
    return found


@pytest.mark.parametrize("trace", [False, True])
def test_ranks_run_the_same_steps(trace):
    # rank 1 leaves the last of the harness's timed set-up steps (after the
    # two warm ones) half a second after rank 0: ranks that each ran the
    # window by their own clock would part by half a second of steps
    seed = 2 ** 31 + 101 + trace
    lag = {"rank": 1, "how": "lag", "step": 2 + run.CAL_STEPS - 1}
    result = run.launch("ntom-collect", seed, 1.0, trace, 2, "cpu",
                        _override(fault=lag), deadline_s=60)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["checks"]["step_spread"]["value"] == 0
    assert result["device"]["count"] == 2
    assert len(result["device"]["memory_peak_bytes_by_rank"]) == 2
    assert "setup_s" in result["metrics"] or trace
    assert result["attempted"] > 0
    assert not _ranks_left(seed)


@pytest.mark.parametrize("step", [0, 4])
def test_a_rank_that_raises_fails_the_run(step):
    seed = 2 ** 31 + 201 + step
    with pytest.raises(run.RankFailure, match="rank 1 exited 1"):
        run.launch("ntom-collect", seed, 0.5, False, 2, "cpu",
                   _override(fault={"rank": 1, "how": "raise", "step": step}),
                   deadline_s=120)
    assert not _ranks_left(seed)


def test_a_rank_that_hangs_is_stopped_at_the_deadline():
    seed = 2 ** 31 + 301
    t = time.monotonic()
    with pytest.raises(run.RankFailure, match="deadline passed"):
        run.launch("ntom-collect", seed, 0.5, False, 2, "cpu",
                   _override(fault={"rank": 1, "how": "hang", "step": 4}),
                   deadline_s=20)
    assert time.monotonic() - t < 20 + 10
    assert not _ranks_left(seed)


def test_ranks_without_cards_leave_no_result(monkeypatch, capsys):
    # a cell on two chips where no card is visible, as on a machine with
    # cards that the run may not see: each rank finds no cuda:r and exits
    # 3, and so does the run, with nothing on standard output
    load_cell = run.load_cell
    monkeypatch.setattr(run, "load_cell", lambda name: (
        {**load_cell(name)[0], "chips": 2}, *load_cell(name)[1:]))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    code = run.main(["--workload", "ntom-collect", "--seed", "5",
                     "--seconds", "0.5"])
    assert code == 3
    assert capsys.readouterr().out == ""
    with pytest.raises(run.RankFailure) as e:
        run.launch("ntom-collect", 6, 0.5, False, 2, "cuda", _override(),
                   deadline_s=120)
    assert e.value.code == 3
    assert capsys.readouterr().out == ""


def _report(rank, uuid, peak, checks, kind="NVIDIA H100 80GB HBM3",
            steps=40, correct=True, **device):
    return {"correct": correct, "attempted": steps, "failed": 0,
            "metrics": {"setup_s": {"value": 10.0 + rank, "unit": "s"}},
            "device": {"platform": "gpu", "kind": kind, "index": rank,
                       "uuid": uuid, "memory_peak_bytes": peak, **device},
            "checks": {k: {"value": v, "limit": 1e-5}
                       for k, v in checks.items()}}


def test_the_merge_takes_the_cards_the_largest_peak_and_the_worst_check():
    reports = [_report(0, "GPU-a", 100, {"gap": 1e-7, "other": 3e-6},
                       power_limit_w=700.0, busy_s=1.0, window_s=2.0),
               _report(1, "GPU-b", 300, {"gap": 2e-6, "other": 1e-7},
                       power_limit_w=650.0, busy_s=1.5, window_s=2.1),
               _report(2, "GPU-c", 200, {"gap": float("nan"), "other": 0.0},
                       power_limit_w=700.0, busy_s=0.5, window_s=2.2,
                       correct=False)]
    out = run.merge(reports, 3)
    dev = out["device"]
    assert dev["count"] == 3 and dev["kind"] == "NVIDIA H100 80GB HBM3"
    assert dev["memory_peak_bytes"] == 300
    assert dev["memory_peak_bytes_by_rank"] == [100, 300, 200]
    assert dev["power_limit_w"] == 650.0
    assert dev["busy_s"] == 1.0 and dev["window_s"] == 2.0
    assert dev["busy_s_by_rank"] == [1.0, 1.5, 0.5]
    assert out["metrics"] == reports[0]["metrics"]
    assert out["checks"]["other"] == {"value": 3e-6, "limit": 1e-5}
    assert out["checks"]["gap"]["value"] != out["checks"]["gap"]["value"]
    assert not out["correct"]
    assert run.merge(reports[:2], 2)["correct"]
    assert run.merge(reports[:2], 2)["checks"]["gap"]["value"] == 2e-6


@pytest.mark.parametrize("uuids", [("GPU-a", "GPU-a"), ("GPU-a", "GPU-b")])
def test_fewer_distinct_cards_than_chips_are_refused(uuids):
    reports = [_report(r, u, 1, {"gap": 0.0}) for r, u in enumerate(uuids)]
    with pytest.raises(run.RankFailure, match="distinct device"):
        run.merge(reports + [_report(2, "GPU-a", 1, {"gap": 0.0})], 3)


def test_a_mix_of_kinds_or_of_step_counts_is_refused():
    a = _report(0, "GPU-a", 1, {"gap": 0.0})
    with pytest.raises(run.RankFailure, match="kinds"):
        run.merge([a, _report(1, "GPU-b", 1, {"gap": 0.0}, kind="other")], 2)
    with pytest.raises(run.RankFailure, match="numbers of steps"):
        run.merge([a, _report(1, "GPU-b", 1, {"gap": 0.0}, steps=41)], 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _four_ranks(seed):
    return run.launch("ntom-collect", seed, 2.0, False, 4, "cuda",
                      _override(), deadline_s=600)


@pytest.mark.cuda
def test_four_ranks_on_four_cards_over_nccl(card):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    result = _four_ranks(2 ** 31 + 401)
    print(json.dumps(result["device"]))
    assert result["correct"], result["checks"]
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 4
    assert dev["kind"] == torch.cuda.get_device_name(0)
    peaks = dev["memory_peak_bytes_by_rank"]
    assert len(peaks) == 4 and min(peaks) > 0
    assert dev["memory_peak_bytes"] == max(peaks)


@pytest.mark.cuda
def test_four_ranks_on_one_card_give_no_result(card, monkeypatch, capsys):
    # the ranks inherit the launcher's environment: ranks 1-3 find no card
    seed = 2 ** 31 + 402
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(run.RankFailure) as e:
        _four_ranks(seed)
    assert e.value.code == 3
    assert capsys.readouterr().out == ""
    assert not _ranks_left(seed)
