"""The port's gymnasium integration: registration, the 5-tuple adapter and
the vector adapter (the three tests of ``tests/test_gymnasium_adapter.py``
against ``gym_supplychain_tpu_torch``, on the CPU)."""
import numpy as np
import pytest

pytest.importorskip("torch")
gymnasium = pytest.importorskip("gymnasium")

from gym_supplychain_tpu_torch.envs.gym_registry import (  # noqa: E402
    GymnasiumVectorAdapter, register_gymnasium)


def test_register_and_run():
    assert register_gymnasium()
    env = gymnasium.make("gym_supplychain_tpu_torch/sc-2perstage-v0",
                         total_time_steps=3, device="cpu")
    obs, info = env.reset(seed=0)
    assert env.observation_space.contains(obs)
    terminated = False
    steps = 0
    while not terminated:
        obs, reward, terminated, truncated, info = env.step(
            env.action_space.sample())
        assert not truncated
        steps += 1
    assert steps == 3


def test_multidiscrete_spaces():
    register_gymnasium()
    env = gymnasium.make("gym_supplychain_tpu_torch/beergame-v2",
                         device="cpu")
    obs, _ = env.reset(seed=1)
    assert env.observation_space.contains(obs)
    obs, r, term, trunc, _ = env.step(env.action_space.sample())
    assert obs.dtype.kind == "i"


def test_vector_adapter():
    B = 8
    vec = GymnasiumVectorAdapter("supplychain-linear-v0", num_envs=B,
                                 total_time_steps=4, device="cpu")
    obs, info = vec.reset(seed=0)
    assert obs.shape == (B, vec.single_observation_space.shape[0])
    for t in range(5):       # crosses the T=4 auto-reset boundary
        a = np.zeros((B, vec.single_action_space.shape[0]), np.float32)
        obs, r, term, trunc, _ = vec.step(a)
        assert obs.shape[0] == B and r.shape == (B,)
        assert term.all() == (t == 3)
    again, _ = vec.reset(seed=0)
    first, _ = GymnasiumVectorAdapter(
        "supplychain-linear-v0", num_envs=B, total_time_steps=4,
        device="cpu").reset(seed=0)
    np.testing.assert_array_equal(again, first)
