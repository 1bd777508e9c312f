"""Checkpoints of the port: exact resume on the CPU.

A run resumed from a checkpoint repeats the uninterrupted run bit for bit:
the scan trainer 2 + 2 iterations against 4 (parameters, Adam's state, the
env state and its Philox keys, the generator), through the API and through
the train CLI, and the fused trainer (its plain version on the CPU) 1 + 1
against 2.  The file loads with ``torch.load(..., weights_only=True)``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.learn import ppo, train  # noqa: E402
from gym_supplychain_tpu_torch.models.policy import ActorCritic  # noqa: E402
from gym_supplychain_tpu_torch.utils.checkpoint import (  # noqa: E402
    FORMAT, restore_checkpoint, save_checkpoint)


def _flat(state):
    params = state["params"] if isinstance(state, dict) else state.params
    return [p.detach().clone() for p in params.flat()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _adam(state):
    return [t for p in state.params.flat()
            for t in state.opt.state[p].values()]


def _trainer(fused):
    cc = make_chain("supplychain-ntom-v0", total_time_steps=6)
    cfg = ppo.PPOConfig(rollout_steps=4, epochs=2, hidden=(8,),
                        minibatches=2)
    if fused:
        return ppo.make_ppo_fused(cc, 4, cfg, device="cpu")
    return ppo.make_ppo(cc, 4, cfg, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_resume_repeats_the_uninterrupted_run(tmp_path, fused):
    n = 1 if fused else 2
    init_fn, step = _trainer(fused)
    state = init_fn(3)
    for _ in range(2 * n):
        state, _ = step(state)

    init_fn, step = _trainer(fused)
    half = init_fn(3)
    for _ in range(n):
        half, _ = step(half)
    path = save_checkpoint(str(tmp_path), half, step=n)
    assert path.endswith(f"step_{n}.pt")
    init_fn, step = _trainer(fused)
    resumed = restore_checkpoint(str(tmp_path), like=init_fn(99))
    assert _same(_flat(resumed), _flat(half))
    for _ in range(n):
        resumed, _ = step(resumed)
    assert _same(_flat(resumed), _flat(state))
    assert _same(_adam(resumed), _adam(state))
    assert torch.equal(resumed.gen.get_state(), state.gen.get_state())
    if not fused:
        assert resumed.env.key == state.env.key
        assert resumed.env.env.ep_key == state.env.env.ep_key
        assert resumed.env.env.t == state.env.env.t
        assert torch.equal(resumed.env.env.stock, state.env.env.stock)
        assert torch.equal(resumed.env.env.pipe, state.env.env.pipe)


def test_train_cli_resume_is_exact(tmp_path):
    base = ["--envs", "4", "--hidden", "8", "--horizon", "6",
            "--rollout-steps", "4", "--log-every", "1", "--device", "cpu",
            "--seed", "5"]
    full, _ = train.main(base + ["--iters", "4"])
    train.main(base + ["--iters", "2", "--checkpoint-dir",
                       str(tmp_path / "a")])
    resumed, _ = train.main(base + ["--iters", "2", "--restore",
                                    str(tmp_path / "a"), "--checkpoint-dir",
                                    str(tmp_path / "b")])
    assert _same(_flat(resumed), _flat(full))
    assert _same(_adam(resumed), _adam(full))
    assert (tmp_path / "b" / "step_2.pt").is_file()


def test_restore_without_a_template_and_its_checks(tmp_path):
    init_fn, step = _trainer(False)
    state, _ = step(init_fn(0))
    save_checkpoint(str(tmp_path), state, step=3)
    first = _flat(state)                  # the step updates in place
    later, _ = step(state)
    save_checkpoint(str(tmp_path), later, step=12)
    raw = torch.load(tmp_path / "step_12.pt", weights_only=True)
    assert raw["format"] == FORMAT and raw["kind"] == "TrainState"
    ck = restore_checkpoint(str(tmp_path))          # the highest step
    assert ck["step"] == 12 and ck["mlp"].hidden == (8,)
    assert isinstance(ck["params"], ActorCritic)
    assert _same(_flat(ck), _flat(later))
    ck3 = restore_checkpoint(str(tmp_path / "step_3.pt"))
    assert ck3["step"] == 3 and _same(_flat(ck3), first)
    with pytest.raises(ValueError, match="FusedTrainState"):
        restore_checkpoint(str(tmp_path), like=_trainer(True)[0](0))
    cc = make_chain("supplychain-ntom-v0", total_time_steps=6)
    other = ppo.make_ppo(cc, 4, ppo.PPOConfig(hidden=(16,)), device="cpu")
    with pytest.raises(ValueError, match="actor-critic"):
        restore_checkpoint(str(tmp_path), like=other[0](0))
    torch.save({"format": "something else"}, tmp_path / "step_99.pt")
    with pytest.raises(ValueError, match=FORMAT):
        restore_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty_dir_missing"))
