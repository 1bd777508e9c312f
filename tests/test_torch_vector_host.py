"""The vec envs' host MT19937 modes and whole-episode tables, against JAX.

* ``VecSupplyChainEnv(rng_mode="host" | "host-lanes")`` equals the JAX env
  of the same mode over two episodes across the auto-reset (float64 both;
  obs atol 5e-7, reward rtol 1e-6 atol 1e-2, the recorded tolerances; stock
  as ``tests/test_torch_single_env.py`` holds it);
* lane b of ``host-lanes`` equals the port's single env seeded ``seed + b``
  and lane b of ``host`` its episode b, bit for bit (one engine);
* ``make_vec_env(rng="table")`` equals ``rng="stateless"`` bit for bit, and
  the JAX table-mode env fed the same tables;
* ``VecBeerGameEnv(rng_mode="host")`` equals JAX's, and lane b a single
  ``BeerGameEnv2(seed=seed + b)``, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.envs import vector as jvector  # noqa: E402

import gym_supplychain_tpu_torch as sct  # noqa: E402
from gym_supplychain_tpu_torch.envs.vector import (  # noqa: E402
    VecBeerGameEnv, VecSupplyChainEnv, make_vec_env)
from gym_supplychain_tpu_torch.rng.device import (  # noqa: E402
    device_episode_tables)

from .test_torch_single_env import _assert_stock  # noqa: E402

T, B = 5, 3
OBS_ATOL, REW_RTOL, REW_ATOL = 5e-7, 1e-6, 1e-2


def _actions(cc, n, seed):
    rs = np.random.RandomState(seed)
    a = (2 * rs.rand(n, cc.A, B) - 1).astype(np.float32)
    a[a < -0.5] = -1.0                  # some supplies must not fire
    return a


def _close(out, jout, exact, what):
    np.testing.assert_allclose(out.obs.numpy(), np.asarray(jout.obs), rtol=0,
                               atol=OBS_ATOL, err_msg=what)
    np.testing.assert_allclose(out.reward.numpy(), np.asarray(jout.reward),
                               rtol=REW_RTOL, atol=REW_ATOL, err_msg=what)
    assert bool(out.done) == bool(jout.done), what


@pytest.mark.parametrize("mode", ["host", "host-lanes"])
@pytest.mark.parametrize("env_id", ["supplychain-ntom-v0",
                                    "sc-2perstage-multiproduct-v1"])
def test_host_modes_match_jax(env_id, mode):
    cc = sct.make_chain(env_id, total_time_steps=T)
    port = VecSupplyChainEnv(cc=cc, batch_size=B, rng_mode=mode, seed=10,
                             dtype=torch.float64, device="cpu")
    ref = jvector.VecSupplyChainEnv(cc=jsct.make(env_id,
                                                 total_time_steps=T).cc,
                                    batch_size=B, rng_mode=mode, seed=10,
                                    dtype=jnp.float64)
    if mode == "host-lanes":
        assert port.lane_rng.backend == "native"
    np.testing.assert_allclose(port.reset().numpy(), np.asarray(ref.reset()),
                               rtol=0, atol=OBS_ATOL)
    for t, a in enumerate(_actions(cc, 2 * T, 1)):
        out, jout = port.step(torch.as_tensor(a)), ref.step(jnp.asarray(a))
        _close(out, jout, False, f"{env_id} {mode} step {t + 1}")
        _assert_stock(port.state.env.stock.numpy(),
                      np.asarray(ref.state.env.stock), False, f"step {t + 1}")


@pytest.mark.parametrize("mode", ["host", "host-lanes"])
def test_host_lanes_equal_single_envs(mode):
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    vec = VecSupplyChainEnv(cc=cc, batch_size=B, rng_mode=mode, seed=10,
                            dtype=torch.float64, device="cpu")
    acts = _actions(cc, 2 * T, 2)
    obs = [vec.reset()]
    outs = [vec.step(torch.as_tensor(a)) for a in acts]
    for b in range(B):
        env = sct.SupplyChainNtoMEnv(total_time_steps=T, device="cpu")
        # host-lanes: lane b is the env seeded 10 + b; host: lane b plays
        # episode b of the stream seeded 10, so its second episode is
        # episode B + b of that stream
        env.seed(10 + b if mode == "host-lanes" else 10)
        for ep in range(2):
            if mode == "host":
                skip = b if ep == 0 else B - 1
                for _ in range(skip):
                    env._rng.episode_tables()
            first = env.reset()
            want = obs[0] if ep == 0 else outs[T - 1].obs
            np.testing.assert_array_equal(first, want[:, b].numpy())
            for t in range(T):
                s = ep * T + t
                o, r, done, _ = env.step(acts[s][:, b])
                assert r == float(outs[s].reward[b]), (mode, b, s)
                if t < T - 1:
                    np.testing.assert_array_equal(o, outs[s].obs[:, b].numpy())
            assert done


def _port_tables(cc, seed, n):
    return [device_episode_tables((seed, k), cc, B, torch.float64, "cpu")
            for k in range(n)]


def test_table_rng_matches_stateless_and_jax(monkeypatch):
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    acts = _actions(cc, 2 * T, 3)
    runs = {}
    for rng in ("table", "stateless"):
        init_fn, step_fn, obs_fn = make_vec_env(cc, B, torch.float64, rng=rng,
                                                device="cpu")
        st = init_fn(4)
        runs[rng] = [obs_fn(st)]
        for a in acts:
            st, out = step_fn(st, torch.as_tensor(a))
            runs[rng].append(out)
    for got, want in zip(runs["table"][1:], runs["stateless"][1:]):
        assert torch.equal(got.obs, want.obs)
        assert torch.equal(got.reward, want.reward)
    # the JAX table mode draws Threefry tables; feed it the port's instead.
    # Its ``lax.cond`` traces the reset branch at every step, so the tables
    # handed out are those of the episode a reset after this step starts
    tables = _port_tables(cc, 4, 3)
    steps = [0]

    def draw(key, cc_, B_, dtype):
        d, lt = tables[steps[0] // T]
        return jnp.asarray(d.numpy()), jnp.asarray(lt.numpy())

    monkeypatch.setattr(jvector, "device_episode_tables", draw)
    jcc = jsct.make("supplychain-ntom-v0", total_time_steps=T).cc
    init_fn, step_fn, obs_fn = jvector.make_vec_env(jcc, B, jnp.float64,
                                                    rng="table")
    st = init_fn(jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(obs_fn(st)),
                               runs["table"][0].numpy(), atol=OBS_ATOL)
    for t, a in enumerate(acts):
        steps[0] = t + 1
        st, jout = step_fn(st, jnp.asarray(a))
        _close(runs["table"][t + 1], jout, False, f"step {t + 1}")


def test_beergame_host_mode_matches_jax_and_single_envs():
    kw = dict(batch_size=B, v2=True, customer_demand=(0, 12),
              shipment_delays=(0, 4), max_stock=40,
              exceeded_capacity_penalty=37, seed=11, rng_mode="host")
    port = VecBeerGameEnv(device="cpu", **kw)
    ref = jvector.VecBeerGameEnv(**kw)
    singles = [sct.BeerGameEnv2(customer_demand=(0, 12),
                                shipment_delays=(0, 4), max_stock=40,
                                exceeded_capacity_penalty=37, seed=11 + b,
                                device="cpu") for b in range(B)]
    W = port.max_weeks
    acts = np.random.RandomState(3).randint(0, 20, size=(2 * W, 4, B))
    obs, jobs = port.reset(), ref.reset()
    for ep in range(2):
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(port.customer_demand.numpy(),
                                      ref.customer_demand)
        np.testing.assert_array_equal(port.shipment_delays.numpy(),
                                      ref.shipment_delays)
        for b, env in enumerate(singles):
            np.testing.assert_array_equal(env.reset(), obs[:, b].numpy())
            np.testing.assert_array_equal(env.customer_demand,
                                          port.customer_demand[:, b].numpy())
        for w in range(W):
            a = acts[ep * W + w]
            obs, r, done = port.step(torch.as_tensor(a))
            jobs, jr, jdone = ref.step(jnp.asarray(a))
            np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
            assert bool(done) == bool(jdone) == (w == W - 1)
            for b, env in enumerate(singles):
                o, rb, _, _ = env.step(a[:, b])
                assert rb == int(r[b])
                if w < W - 1:
                    np.testing.assert_array_equal(o, obs[:, b].numpy())
