"""Batched envs of the port: the auto-reset contract and the Philox rows.

* auto-reset at the shared clock: at the episode boundary ``done`` is set,
  the terminal obs is replaced by the first obs of a fresh episode, and the
  next episode plays a fresh stream;
* ``stateless_step_rows`` draws its lead-time and demand rows with the exact
  distributions (the checks of ``tests/test_rng_distribution.py`` on the
  Philox rows instead of Threefry).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.core.step import (  # noqa: E402
    make_supplychain_kernels)
from gym_supplychain_tpu_torch.envs.vector import (  # noqa: E402
    VecBeerGameEnv, VecSupplyChainEnv, make_beergame_table_draw, make_vec_env)
from gym_supplychain_tpu_torch.rng.device import (  # noqa: E402
    poisson_clip_thresholds, stateless_step_rows)


def _clipped_poisson_pmf(lam, lmax):
    """Exact float64 PMF of clip(1 + Poisson(lam), 1, lmax) over 1..lmax."""
    pmf = np.zeros(lmax)
    term = math.exp(-lam)
    for k in range(lmax - 1):
        pmf[k] = term
        term *= lam / (k + 1)
    pmf[lmax - 1] = 1.0 - pmf[:lmax - 1].sum()
    return pmf


def _pmf(x, lo, hi):
    x = np.asarray(x).ravel().astype(np.int64)
    return np.bincount(x - lo, minlength=hi - lo + 1)[:hi - lo + 1] / x.size


@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_vec_env_auto_reset_contract(env_id):
    T, B = 5, 4
    cc = make_chain(env_id, total_time_steps=T)
    init_fn, step_fn, obs_fn = make_vec_env(cc, B)
    _, _, obs_k = make_supplychain_kernels(cc, stateless_rng=True)
    state = init_fn(7)
    first_dem = state.env.demands.clone()
    rs = np.random.RandomState(0)
    for t in range(1, 2 * T + 1):
        prev = state
        state, out = step_fn(state, torch.as_tensor(
            2 * rs.rand(cc.A, B) - 1, dtype=torch.float32))
        assert out.done == (t % T == 0)
        assert out.obs.shape == (cc.obs_dim, B)
        assert bool(torch.isfinite(out.obs).all() and torch.isfinite(out.reward).all())
        if out.done:
            # the terminal obs is the fresh episode's first obs
            assert state.env.t == 0 and state.key[1] == prev.key[1] + 1
            assert torch.equal(out.obs, obs_k(state.env))
            assert torch.equal(state.env.stock,
                               torch.as_tensor(cc.initial_stock, dtype=torch.float32)
                               [..., None].expand(cc.N, cc.P, B))
        else:
            assert state.env.t == t % T
            assert torch.equal(out.obs, obs_fn(state))
    assert not torch.equal(state.env.demands, first_dem)


def test_vec_supplychain_env_resets_continue_the_stream():
    cc = make_chain("supplychain-ntom-v0", total_time_steps=4)
    a = VecSupplyChainEnv(cc=cc, batch_size=6, seed=3)
    b = VecSupplyChainEnv(cc=cc, batch_size=6, seed=3)
    o1, o2 = a.reset(), a.reset()
    assert not torch.equal(o1, o2)               # fresh episodes
    assert torch.equal(b.reset(), o1)            # a seed reproduces them
    assert a.action_shape == (cc.A, 6)
    act = torch.zeros(a.action_shape)
    for _ in range(4):
        out = a.step(act)
    assert out.done and a.state.env.t == 0


def test_vec_beergame_env_auto_reset_and_draws():
    env = VecBeerGameEnv(batch_size=8, customer_demand=(0, 12),
                         shipment_delays=(0, 4), v2=True, max_stock=40,
                         exceeded_capacity_penalty=37, seed=2, weeks=10)
    obs0 = env.reset()
    dem0 = env.state.customer_demand.clone()
    assert obs0.shape == (4, 8)
    assert int(dem0.min()) >= 0 and int(dem0.max()) < 12
    d = env.state.shipment_delays
    assert (d[0] == 2).all() and int(d[1:].min()) >= 0 and int(d[1:].max()) < 4
    act = torch.full((4, 8), 3, dtype=torch.int32)
    for w in range(10):
        obs, rew, done = env.step(act)
        assert done == (w == 9)
    assert torch.equal(obs, 40 + env.state.inventory - env.state.backlog)
    assert env.state.week == 0
    assert not torch.equal(env.state.customer_demand, dem0)
    draw = make_beergame_table_draw(10, dem_range=(0, 12),
                                    scripted_delays=[2] * 11)
    dem, delays = draw((2, 0), 8)
    assert torch.equal(dem, dem0) and (delays == 2).all()


def test_stateless_step_rows_marginals():
    cc = make_chain("supplychain-ntom-v0")
    assert cc.stochastic_leadtimes and cc.Lavg == 2 and cc.Lmax == 4
    B, n_keys = 8192, 16
    dems, lts = [], []
    for s in range(n_keys):
        d, lt = stateless_step_rows((s, 1), s * 7 + 1, cc, B)
        assert d.shape == (cc.R, cc.P, B) and lt.shape == (cc.K, B)
        dems.append(d.numpy())
        lts.append(lt.numpy())
    lt_all = np.concatenate(lts, axis=-1)
    dem_all = np.concatenate(dems, axis=-1)
    sig_lt = 6 * 0.5 / math.sqrt(lt_all.size)
    np.testing.assert_allclose(_pmf(lt_all, 1, cc.Lmax),
                               _clipped_poisson_pmf(cc.Lavg - 1, cc.Lmax),
                               atol=sig_lt)
    np.testing.assert_allclose(_pmf(dem_all, 10, 20), np.full(11, 1 / 11),
                               atol=6 * 0.5 / math.sqrt(dem_all.size))
    cdf = poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax)
    assert cdf.dtype == np.float32 and len(cdf) == cc.Lmax - 1
    # distinct keys and steps give distinct rows
    assert not np.array_equal(lts[0], lts[1])
    assert not np.array_equal(dems[0], dems[1])
