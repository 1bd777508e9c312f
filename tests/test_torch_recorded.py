"""The port against the committed reference recordings.

The port's form of ``tests/test_recorded_trajectory.py``: the recorded
reference episodes (``tests/data/ref_trajectories.npz`` and
``ref_beergame.npz``) replay through the port's strict-obs single envs on
the CPU, step by step, at that file's tolerances (obs atol 5e-7; reward
rtol 1e-6, atol 1e-2; the beer game exact).  The scenario table is the
port's own (``tests/fixture_scenarios.py`` builds JAX envs); a test holds
its names and seeds to that file's.  No JAX runs here.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import gym_supplychain_tpu_torch as sct  # noqa: E402

from .fixture_scenarios import SC_SCENARIOS, beergame_scenarios  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
STOCHASTIC = dict(stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4)


def _partial_supply_nodes():
    return {
        'Sup': {'initial_stock': [5, 5], 'stock_capacity': [50, 50],
                'stock_cost': [1, 1], 'supply_capacity': [30, 0],
                'supply_cost': [2, 0], 'destinations': ['Ret'],
                'dest_costs': [[1], [1]], 'ship_capacity': [40]},
        'Ret': {'initial_stock': [5, 5], 'stock_capacity': [50, 50],
                'stock_cost': [1, 1], 'last_level': True},
    }


# name -> (seed, env class, keyword arguments); two episodes each
PORT_SC_SCENARIOS = {
    "2perstage_stochastic_leadtimes": (
        0, "SupplyChain2perStageEnv", dict(total_time_steps=60, **STOCHASTIC)),
    "ntom_stochastic": (3, "SupplyChainNtoMEnv", dict(total_time_steps=60)),
    "multiproduct_constant_leadtimes": (
        1, "SupplyChainMultiProduct", dict(total_time_steps=40)),
    "partial_supply_products": (
        2, "SupplyChainEnv", dict(nodes_info=_partial_supply_nodes(),
                                  num_products=2, demand_range=(0, 8),
                                  total_time_steps=30, **STOCHASTIC)),
    "seasonal_2perstage_stochastic": (
        4, "SupplyChain2perStageSeasonalEnv",
        dict(total_time_steps=40, **STOCHASTIC)),
    "demconfigbyprod": (5, "SupplyChainMultiProduct_DemConfigByProd",
                        dict(num_products=3, total_time_steps=40)),
    "nperstage_3_2_3_5": (6, "SupplyChainNPerStage",
                          dict(nodes_per_echelon=[3, 2, 3, 5],
                               total_time_steps=30, **STOCHASTIC)),
}


@pytest.fixture(scope="module")
def sc_fixture():
    return np.load(os.path.join(DATA, "ref_trajectories.npz"))


@pytest.fixture(scope="module")
def bg_fixture():
    return np.load(os.path.join(DATA, "ref_beergame.npz"))


def test_port_scenarios_are_the_recorded_ones():
    assert sorted(PORT_SC_SCENARIOS) == sorted(SC_SCENARIOS)
    for name, (seed, _, _) in PORT_SC_SCENARIOS.items():
        assert seed == SC_SCENARIOS[name]["seed"]
        assert SC_SCENARIOS[name]["episodes"] == 2


@pytest.mark.parametrize("name", sorted(PORT_SC_SCENARIOS))
def test_recorded_supplychain_trajectory(name, sc_fixture):
    seed, cls, kw = PORT_SC_SCENARIOS[name]
    env = getattr(sct, cls)(strict_obs=True, device="cpu", **kw)
    env.seed(seed)
    for ep in range(2):
        actions = sc_fixture[f"{name}/ep{ep}/actions"]
        ref_obs = sc_fixture[f"{name}/ep{ep}/obs"]
        ref_rews = sc_fixture[f"{name}/ep{ep}/rewards"]
        obs = env.reset()
        np.testing.assert_allclose(obs, ref_obs[0], atol=5e-7,
                                   err_msg=f"{name} ep{ep} reset obs")
        total = ref_total = 0.0
        for t in range(actions.shape[0]):
            obs, r, done, _ = env.step(actions[t])
            np.testing.assert_allclose(
                obs, ref_obs[t + 1], atol=5e-7,
                err_msg=f"{name} ep{ep} obs at t={t + 1}")
            assert np.allclose(r, ref_rews[t], rtol=1e-6, atol=1e-2), \
                (name, ep, t + 1, r, ref_rews[t])
            total += r
            ref_total += ref_rews[t]
        assert done
        assert np.allclose(total, ref_total), (name, ep, total, ref_total)


@pytest.mark.parametrize("name", sorted(beergame_scenarios()))
def test_recorded_beergame_trajectory(name, bg_fixture):
    spec = beergame_scenarios()[name]
    env = getattr(sct, spec["cls"])(*spec["args"], device="cpu",
                                    **spec["kwargs"])
    for ep, actions in enumerate(spec["actions"]):
        obs = env.reset()
        np.testing.assert_array_equal(obs, bg_fixture[f"{name}/ep{ep}/obs"][0],
                                      err_msg=f"{name} ep{ep} reset obs")
        np.testing.assert_array_equal(
            env.customer_demand, bg_fixture[f"{name}/ep{ep}/customer_demand"])
        np.testing.assert_array_equal(
            env.shipment_delays, bg_fixture[f"{name}/ep{ep}/shipment_delays"])
        for t in range(actions.shape[0]):
            obs, r, done, _ = env.step(actions[t])
            np.testing.assert_array_equal(
                obs, bg_fixture[f"{name}/ep{ep}/obs"][t + 1],
                err_msg=f"{name} ep{ep} obs week {t + 1}")
            assert float(r) == bg_fixture[f"{name}/ep{ep}/rewards"][t], \
                (name, ep, t + 1)
        assert done
        np.testing.assert_array_equal(env.inventory,
                                      bg_fixture[f"{name}/ep{ep}/inventory"])
        np.testing.assert_array_equal(env.backlog,
                                      bg_fixture[f"{name}/ep{ep}/backlog"])
