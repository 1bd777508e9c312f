"""The port's eager step engine against the JAX engine, step by step.

Both run ``make_supplychain_kernels`` on the same compiled chain, the same
numpy demand, lead-time and action tables, in float32 and float64, and every
step's observation, reward, costs, units, stock and pipeline are compared.

Tolerances.  The port divides with IEEE division and rounds every product
before adding it (the CUDA kernel it is the plain version of must agree with
it bit for bit).  XLA:CPU does neither: it rewrites ``x / const`` into
``x * (1 / const)`` and contracts ``a * b + c`` into FMA.  So the engines
agree bit for bit where no such rewrite is inexact (the linear chain: its
processing ratio 2 has an exact reciprocal) and within a few float32 ulps
elsewhere.  Observed worst cases over 6 seeds at T=20, B=8: float32 obs
4.8e-7, rewards, stock, pipeline, costs and units 5.1e-7 relative to their
largest magnitude; float64 1.3e-15 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.core.step import (  # noqa: E402
    make_supplychain_kernels as jax_kernels)

from gym_supplychain_tpu_torch.core.step import (  # noqa: E402
    COST_KEYS, make_supplychain_kernels, state_from_numpy, state_to_numpy)

ENVS = ["supplychain-linear-v0", "supplychain-ntom-v0",
        "supplychain-2perstage-v0"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "f64": (jnp.float64, torch.float64, 1e-12)}
OBS_ATOL = {"f32": 1e-6, "f64": 1e-12}


def _tables(cc, T, B, seed):
    rs = np.random.RandomState(seed)
    acts = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    acts[acts < -0.5] = -1.0            # some supplies must not fire
    dem = rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    lt = (rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B)).astype(np.int32)
          if cc.stochastic_leadtimes else None)
    return acts, dem, lt


def _close(got, want, rel, exact=False, what=""):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                                   err_msg=what)


def _compare_step(jst, jout, tst, tout, dt, exact):
    rel = DTYPES[dt][2]
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), rtol=0,
                               atol=OBS_ATOL[dt])
    _close(tout.reward, jout.reward, rel, what="reward")
    _close(tout.costs, jout.costs, rel, what="costs")
    _close(tout.units, jout.units, rel, what="units")
    _close(tst.stock, jst.stock, rel, exact, "stock")
    _close(tst.pipe, jst.pipe, rel, exact, "pipe")
    assert bool(tout.done) == bool(jout.done)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("env_id", ENVS)
def test_engine_matches_jax(env_id, dt):
    T, B = 12, 6
    cc = jsct.make(env_id, total_time_steps=T).cc
    acts, dem, lt = _tables(cc, T, B, seed=ENVS.index(env_id))
    jdt, tdt, _ = DTYPES[dt]
    j_reset, j_step, j_obs = jax_kernels(cc, dtype=jdt)
    t_reset, t_step, t_obs = make_supplychain_kernels(cc, dtype=tdt)
    jst, tst = j_reset(dem, lt, B), t_reset(dem, lt, B)
    np.testing.assert_allclose(t_obs(tst).numpy(), np.asarray(j_obs(jst)),
                               rtol=0, atol=OBS_ATOL[dt])
    j_step = jax.jit(j_step)
    for t in range(T):
        jst, jout = j_step(jst, jnp.asarray(acts[t]))
        tst, tout = t_step(tst, torch.as_tensor(acts[t]))
        _compare_step(jst, jout, tst, tout, dt,
                      exact=env_id == "supplychain-linear-v0")
    assert tout.costs.shape == (len(COST_KEYS), cc.P, B)
    _close(tst.ep_reward, jst.ep_reward, DTYPES[dt][2], what="ep_reward")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_continue_from_jax_mid_episode_state(dt):
    """Snapshot the JAX state mid-episode, carry it across with
    ``state_from_numpy`` and step both engines on from it."""
    T, B, split = 14, 5, 6
    cc = jsct.make("supplychain-ntom-v0", total_time_steps=T).cc
    acts, dem, lt = _tables(cc, T, B, seed=11)
    jdt, tdt, _ = DTYPES[dt]
    j_reset, j_step, _ = jax_kernels(cc, dtype=jdt)
    _, t_step, t_obs = make_supplychain_kernels(cc, dtype=tdt)
    j_step = jax.jit(j_step)
    jst = j_reset(dem, lt, B)
    for t in range(split):
        jst, _ = j_step(jst, jnp.asarray(acts[t]))
    snap = {k: (None if v is None else np.asarray(v))
            for k, v in jst._asdict().items()}
    tst = state_from_numpy(snap)
    assert tst.t == split and tst.stock.dtype == tdt
    back = state_to_numpy(tst)
    for k, v in snap.items():
        if v is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    for t in range(split, T):
        jst, jout = j_step(jst, jnp.asarray(acts[t]))
        tst, tout = t_step(tst, torch.as_tensor(acts[t]))
        _compare_step(jst, jout, tst, tout, dt, exact=False)
    assert tout.done


def test_debug_push_outputs_match_jax():
    T, B = 8, 4
    cc = jsct.make("supplychain-ntom-v0", total_time_steps=T).cc
    acts, dem, lt = _tables(cc, T, B, seed=3)
    j_reset, j_step, _ = jax_kernels(cc, debug=True)
    t_reset, t_step, _ = make_supplychain_kernels(cc, debug=True)
    j_step = jax.jit(j_step)
    jst, tst = j_reset(dem, lt, B), t_reset(dem, lt, B)
    for t in range(T):
        jst, jout = j_step(jst, jnp.asarray(acts[t]))
        tst, tout = t_step(tst, torch.as_tensor(acts[t]))
        np.testing.assert_array_equal(tout.sup_lt.numpy(), np.asarray(jout.sup_lt))
        np.testing.assert_array_equal(tout.ship_lt.numpy(),
                                      np.asarray(jout.ship_lt))
        _close(tout.sup_push, jout.sup_push, 1e-5, what="sup_push")
        _close(tout.ship_push, jout.ship_push, 1e-5, what="ship_push")
