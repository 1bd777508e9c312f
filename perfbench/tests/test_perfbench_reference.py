"""The plain reference against the program's plain paths, on the CPU at
small sizes, and against the program's kernels on the card (``cuda``)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import philox, policy, ppo, rollouts
from perfbench.reference.chain import compile_chain

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
NAMES = ("ntom", "sc2perstage")
SEED = 2 ** 31 + 12345


def _config(name, T):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    return {**cfg, "horizon": T}


def _port_chain(cfg):
    import gym_supplychain_tpu_torch as port

    return port.make_chain(cfg["env_id"], total_time_steps=cfg["horizon"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("name", NAMES)
def test_chain_matches_the_program(name):
    cfg = _config(name, 360)
    ch, cc = compile_chain(cfg["chain"], 360), _port_chain(cfg)
    for k in ("N", "P", "R", "A", "K", "T", "Lavg", "Lmax", "H", "Dmax",
              "obs_dim"):
        assert getattr(ch, k) == getattr(cc, k), k
    assert ch.stochastic == cc.stochastic_leadtimes
    for k in ("retailer_idx", "initial_stock", "init_pipe", "stock_cap",
              "stock_cost", "has_supply", "supply_cap", "supply_cost",
              "proc_cap", "proc_cost", "proc_ratio", "is_factory",
              "edge_dst", "edge_mask", "ship_cap_edge", "ship_cost",
              "has_ship", "sup_act_idx", "ship_act_idx", "lt_base",
              "max_ship"):
        np.testing.assert_array_equal(getattr(ch, k), getattr(cc, k), k)
    for k in ("c_unmet", "c_stock_pen", "c_proc_pen", "c_ship_pen"):
        assert getattr(ch, k) == getattr(cc, k), k
    assert (ch.dem_min, ch.dem_max) == (cc.demand[0].minv, cc.demand[0].maxv)


def test_philox_matches_the_program():
    from gym_supplychain_tpu_torch.rng.device import (philox_uniform,
                                                      poisson_clip_thresholds)

    key = philox.seed_key(2 ** 63 + 2 ** 40 + 77)
    a = philox.philox_uniform(key, range(3, 9), 11, 37, "cpu")
    b = philox_uniform(key, range(3, 9), 11, 37, "cpu")
    assert torch.equal(a, b)
    np.testing.assert_array_equal(philox.leadtime_cdf(1.0, 4),
                                  poisson_clip_thresholds(1.0, 4))


@pytest.mark.parametrize("name", NAMES)
def test_random_collection_matches_the_plain_version(name):
    from gym_supplychain_tpu_torch.ops.supplychain_collect import (
        supplychain_collect_plain)

    cfg = _config(name, 12)
    ch = compile_chain(cfg["chain"], 12)
    seed = 2 ** 64 - 12345
    obs, rew = rollouts.collect_random(ch, seed, 9, "cpu")
    p_obs, p_rew, _ = supplychain_collect_plain(_port_chain(cfg), 1, 9,
                                                "random", seed=seed,
                                                device="cpu")
    assert float((obs - p_obs).abs().max()) <= 1e-6
    assert float((rew - p_rew).abs().max()) <= 1e-6 * float(
        p_rew.abs().max())


@pytest.mark.parametrize("name", NAMES)
def test_policy_collection_matches_the_plain_version(name):
    from gym_supplychain_tpu_torch.ops.supplychain_collect import (
        supplychain_collect_plain)

    cfg = _config(name, 10)
    ch = compile_chain(cfg["chain"], 10)
    flat, _ = policy.init_params(ch.obs_dim, ch.A, (16, 8), 3, "cpu")
    flat[len(flat) // 2 - 2] = flat[len(flat) // 2 - 2] * 100   # mu's w
    out = rollouts.collect_policy(ch, flat, SEED, 7, "cpu")
    prog = supplychain_collect_plain(_port_chain(cfg), 1, 7, "policy",
                                     seed=SEED, params=flat, device="cpu")
    for a, b in zip(out, prog[:5]):
        assert float((a - b).abs().max()) <= 2e-5 * max(
            1.0, float(b.abs().max()))


def test_init_matches_the_program():
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig

    flat, gen = policy.init_params(27, 14, (32, 16), 99, "cpu")
    g = torch.Generator().manual_seed(99)
    model = ActorCritic(MLPConfig(27, 14, (32, 16)), g, "cpu")
    for a, b in zip(flat, model.flat(), strict=True):
        assert torch.equal(a, b.detach())
    assert torch.equal(torch.randint(0, 2 ** 62, (4,), generator=gen),
                       torch.randint(0, 2 ** 62, (4,), generator=g))


@pytest.mark.parametrize("name", NAMES)
def test_greedy_episode_matches_the_plain_runner(name):
    from gym_supplychain_tpu_torch.ops.supplychain_episode import (
        make_supplychain_policy_rollout)
    from gym_supplychain_tpu_torch.rng.device import device_episode_tables
    from perfbench.drivers.evaluate import weights

    cfg = _config(name, 11)
    ch, cc = compile_chain(cfg["chain"], 11), _port_chain(cfg)
    flat = weights(ch.obs_dim, ch.A, (16, 16), 5, "cpu")
    key = (SEED % 2 ** 32, 3)
    ref = rollouts.greedy_returns(ch, flat, key, 6, "cpu")
    dem, lt = device_episode_tables(key, cc, 6, device="cpu")
    run = make_supplychain_policy_rollout(cc, 11, 6, (16, 16), device="cpu")
    got = run(dem, *([lt] if cc.stochastic_leadtimes else []), flat).sum(0)
    assert float((ref - got).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("name", NAMES)
def test_training_matches_the_fused_trainer(name):
    from gym_supplychain_tpu_torch.learn.ppo import PPOConfig, make_ppo_fused

    cfg = _config(name, 12)
    ch = compile_chain(cfg["chain"], 12)
    o = cfg["ppo"]
    pc = PPOConfig(epochs=o["epochs"], lr=o["lr"], clip=o["clip"],
                   hidden=tuple(cfg["hidden"]), minibatches=1,
                   fused_update=True)
    init_fn, step = make_ppo_fused(_port_chain(cfg), 24, pc, device="cpu",
                                   reward_scale=o["reward_scale"])
    state = init_fn(SEED)
    losses = [float(step(state)[1]["loss"]) for _ in range(2)]
    ref = ppo.train(ch, cfg, SEED, 24, 2, "cpu")
    np.testing.assert_allclose(losses, ref["loss"], rtol=2e-5)
    for a, b in zip(state.params.flat(), ref["params"], strict=True):
        assert float((a.detach() - b).abs().max()) <= 1e-5


def test_gae_of_one_episode():
    r = torch.tensor([[1.0], [2.0], [3.0]])
    v = torch.tensor([[0.5], [0.25], [0.125]])
    adv = ppo.gae(r, v, 0.9, 0.5)
    d2 = 3.0 - 0.125
    d1 = 2.0 + 0.9 * 0.125 - 0.25
    d0 = 1.0 + 0.9 * 0.25 - 0.5
    want = [d0 + 0.45 * (d1 + 0.45 * d2), d1 + 0.45 * d2, d2]
    np.testing.assert_allclose(adv[:, 0].numpy(), want, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_reference_matches_the_kernels_on_the_card(name, card):
    """K1 ``random``, K1 ``policy`` and K4 against the reference at a small
    size on the card."""
    import gym_supplychain_tpu_torch as port  # noqa: F401
    from gym_supplychain_tpu_torch.learn.evaluate import make_fused_evaluator
    from gym_supplychain_tpu_torch.ops.supplychain_collect import (
        make_supplychain_collect)
    from perfbench import compare
    from perfbench.drivers.evaluate import weights

    cfg = _config(name, 30)
    ch, cc = compile_chain(cfg["chain"], 30), _port_chain(cfg)
    with ppo.precision(False):
        obs, rew = make_supplychain_collect(cc, 30, 99, "random",
                                            device=card)(SEED)
        r_obs, r_rew = rollouts.collect_random(ch, SEED, 99, card)
        assert compare.max_abs_gap(obs, r_obs) <= 1e-6
        assert compare.max_abs_gap(rew, r_rew) <= 1e-6 * float(
            r_rew.abs().max())
        flat = weights(ch.obs_dim, ch.A, cfg["hidden"], 3, card)
        run = make_supplychain_collect(cc, 30, 99, "policy", device=card,
                                       hidden=tuple(cfg["hidden"]))
        for a, b in zip(run(flat, SEED), rollouts.collect_policy(
                ch, flat, SEED, 99, card)):
            assert compare.max_abs_gap(a, b) <= 1e-4 * max(
                1.0, float(b.abs().max()))
        got = make_fused_evaluator(cc, 99, tuple(cfg["hidden"]),
                                   device=card)(flat, (SEED % 2 ** 32, 4))
        want = compare.stats(rollouts.greedy_returns(
            ch, flat, (SEED % 2 ** 32, 4), 99, card))
        for k, v in want.items():
            assert abs(float(got[k]) - v) <= 1e-5 * abs(want["mean_return"])
