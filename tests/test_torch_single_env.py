"""The port's single envs and ``make()`` against the JAX package's.

For every id of the JAX registry, ``make(id, device="cpu")`` and the JAX
``make(id)`` are seeded alike and stepped through a short episode (T cut to
20 where the id takes ``total_time_steps``) with the actions the reference's
tests use, ``action_space.sample()`` (a seeded stream where an env has no
space).  Both run float64 (``tests/conftest.py`` turns on x64).
Observations and rewards agree within the recorded reference tolerances of
``tests/test_recorded_trajectory.py`` (obs atol 5e-7; reward rtol 1e-6,
atol 1e-2), the beer game's exactly, and so do ``done`` and the episode
info.  Stock is bit-equal where XLA:CPU rewrites no float operation
inexactly (the linear chain: its processing ratio 2 has an exact
reciprocal); elsewhere XLA turns ``x / ratio`` into ``x * (1 / ratio)`` and
contracts products into FMA while the port divides and rounds as the
reference's numpy does, so stock agrees within ``STOCK_RTOL`` of its
largest magnitude (observed at most 7.2e-16 over these episodes, a few
float64 ulps).  Then the reference's golden return on the multi-product
chain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402

import gym_supplychain_tpu_torch as sct  # noqa: E402

from .utils import simple_chain  # noqa: E402

T = 20
OBS_ATOL, REW_RTOL, REW_ATOL = 5e-7, 1e-6, 1e-2
STOCK_RTOL = 4e-15


def _kwargs(env_id):
    if env_id == "beergame-v0":
        return {}
    if env_id == "beergame-v2":
        return dict(customer_demand=(0, 12), shipment_delays=(0, 4), seed=3)
    kw = dict(total_time_steps=T, build_info=True)
    if env_id == "supplychain-v0":
        kw.update(nodes_info=simple_chain(), stochastic_leadtimes=True,
                  max_leadtime=4, demand_range=(0, 5))
    return kw


def _actions(env, env_id, n):
    if env_id == "beergame-v0":
        return list(np.random.RandomState(1).randint(0, 16, size=(n, 4)))
    if env_id == "beergame-v2":
        env.action_space.seed(1)
    return [env.action_space.sample() for _ in range(n)]


def _assert_info_close(got, want):
    assert got.keys() == want.keys()
    if not want:
        return
    got, want = got["sc_episode"], want["sc_episode"]
    assert np.allclose(got["rewards"], want["rewards"], rtol=REW_RTOL,
                       atol=REW_ATOL)
    for part in ("costs", "units"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       rtol=REW_RTOL, atol=REW_ATOL,
                                       err_msg=f"{part}/{k}")


def _assert_stock(got, want, exact, what):
    if exact or not want.size:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=STOCK_RTOL * max(float(np.abs(want).max()), 1.0),
            err_msg=what)


def _run_both(env_id, strict_obs=False, episodes=2):
    kw = _kwargs(env_id)
    if strict_obs:
        kw["strict_obs"] = True
    port = sct.make(env_id, device="cpu", **kw)
    ref = jsct.make(env_id, **kw)
    beergame = env_id.startswith("beergame")
    if hasattr(ref, "seed") and not beergame:
        port.seed(11)
        ref.seed(11)
    for ep in range(episodes):       # the second continues the streams
        got, want = port.reset(), ref.reset()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=0 if beergame else OBS_ATOL)
        n = ref.max_weeks if beergame else ref.cc.T
        for t, a in enumerate(_actions(ref, env_id, n)):
            got, want = port.step(a), ref.step(a)
            what = f"{env_id} episode {ep} step {t + 1}"
            if beergame:
                np.testing.assert_array_equal(got[0], want[0], err_msg=what)
                assert got[1] == want[1], what
                np.testing.assert_array_equal(port.inventory, ref.inventory)
                np.testing.assert_array_equal(port.backlog, ref.backlog)
            else:
                np.testing.assert_allclose(got[0], want[0], rtol=0,
                                           atol=OBS_ATOL, err_msg=what)
                assert np.allclose(got[1], want[1], rtol=REW_RTOL,
                                   atol=REW_ATOL), (what, got[1], want[1])
                _assert_stock(port.state.stock.numpy(),
                              np.asarray(ref.state.stock),
                              env_id == "supplychain-linear-v0", what)
                assert port.time_step == ref.time_step
                _assert_info_close(got[3], want[3])
            assert got[2] == want[2], what
        assert got[2]


@pytest.mark.parametrize("env_id", jsct.registry())
def test_make_matches_jax(env_id):
    _run_both(env_id)


@pytest.mark.parametrize("env_id", [e for e in jsct.registry()
                                    if not e.startswith("beergame")])
def test_strict_obs_matches_jax(env_id):
    _run_both(env_id, strict_obs=True, episodes=1)


def test_single_env_surface():
    """Seeding reproduces both episodes; a longer action vector's tail is
    ignored; the state inspection matches JAX's."""
    port = sct.make("supplychain-ntom-v0", total_time_steps=6, device="cpu")
    ref = jsct.make("supplychain-ntom-v0", total_time_steps=6)
    assert port.dtype == torch.float64
    a = np.linspace(-1, 1, port.cc.A + 3).astype(np.float32)
    for env in (port, ref):
        env.seed(4)
        env.reset()
        env.step(a)
        env.step(a)
    for n in range(port.cc.N):
        _assert_stock(port.stock(n), ref.stock(n), False, f"node {n}")
        got, want = port.pipeline(n), ref.pipeline(n)
        assert [t for t, _ in got] == [t for t, _ in want]
        _assert_stock(np.array([a for _, a in got]),
                      np.array([a for _, a in want]), False, f"pipe {n}")
    np.testing.assert_array_equal(port.customer_demands, ref.customer_demands)
    first = port.customer_demands
    port.reset()
    assert not np.array_equal(port.customer_demands, first)
    port.seed(4)
    port.reset()
    np.testing.assert_array_equal(port.customer_demands, first)


def test_multiproduct_golden_return():
    """The reference's golden regression (test_multiproduct_2perstage.py):
    ``SupplyChainMultiProduct()``, ``seed(0)``, 360 steps of
    ``action_space.sample()``."""
    env = sct.SupplyChainMultiProduct(device="cpu")
    env.seed(0)
    env.reset()
    total, done = 0.0, False
    while not done:
        _, r, done, _ = env.step(env.action_space.sample())
        total += r
    assert env.time_step == 360
    assert np.allclose(total, -34704704.078214735), total
