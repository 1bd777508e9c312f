"""Beer game: the port's int32 engine and collect plain version against JAX.

Integer arithmetic throughout, so everything is bit-exact: the engine
against ``make_beergame_kernels(itype=int32)``, and the collect kernel's
plain version against ``make_beergame_collect_pallas(..., interpret=True)``
on the cases of ``tests/test_pallas_ops.py`` (v0 over an auto-reset
boundary, v2 with per-lane stochastic delays including zero delays, v2 with
a scalar delay).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu.core.beergame import (  # noqa: E402
    make_beergame_kernels as jax_kernels)
from gym_supplychain_tpu.ops.beergame_pallas import (  # noqa: E402
    make_beergame_collect_pallas)

from gym_supplychain_tpu_torch.core.beergame import (  # noqa: E402
    make_beergame_kernels)
from gym_supplychain_tpu_torch.core.step import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from gym_supplychain_tpu_torch.ops import beergame_collect as bgc  # noqa: E402

V2 = dict(v2=True, max_stock=25, exceeded_capacity_penalty=37)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("variant", ["v0", "v2"])
def test_engine_matches_jax_bit_exact(variant):
    W, L, B, MAXD = 20, 4, 8, 3
    kw = V2 if variant == "v2" else {}
    rs = np.random.RandomState(4)
    demand = rs.randint(0, 12, size=(W, B)).astype(np.int32)
    delays = np.concatenate([np.full((1, B), 2, np.int32),
                             rs.randint(0, MAXD + 1, size=(W, B))
                             .astype(np.int32)])
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    j_reset, j_step, _ = jax_kernels(L, W, MAXD, itype=jnp.int32, **kw)
    t_reset, t_step, _ = make_beergame_kernels(L, W, MAXD, device="cpu", **kw)
    jst = j_reset(demand, delays, [12] * L, 4, 4, B)
    tst = t_reset(demand, delays, [12] * L, 4, 4, B)
    j_step = jax.jit(j_step)
    for w in range(W):
        jst, (jo, jr, jd) = j_step(jst, actions[w])
        tst, (to, tr, td) = t_step(tst, torch.as_tensor(actions[w]))
        _eq(to, jo, "obs")
        _eq(tr, jr, "reward")
        assert bool(td) == bool(jd)
        for f in ("inventory", "backlog", "orders_placed", "incoming_orders",
                  "shipments", "inventory_costs", "backlog_costs",
                  "penalty_costs"):
            _eq(getattr(tst, f), getattr(jst, f), f)
    assert td


def test_continue_from_jax_mid_episode_state():
    W, L, B = 15, 4, 6
    rs = np.random.RandomState(8)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    delays = np.full(W + 1, 2, np.int32)
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    j_reset, j_step, _ = jax_kernels(L, W, 2, itype=jnp.int32)
    _, t_step, _ = make_beergame_kernels(L, W, 2, device="cpu")
    j_step = jax.jit(j_step)
    jst = j_reset(demand, delays, [12] * L, 4, 4, B)
    for w in range(7):
        jst, _ = j_step(jst, actions[w])
    snap = {k: np.asarray(v) for k, v in jst._asdict().items()}
    tst = state_from_numpy(snap, device="cpu")
    assert tst.week == 7
    for k, v in state_to_numpy(tst).items():
        np.testing.assert_array_equal(v, snap[k], err_msg=k)
    for w in range(7, W):
        jst, (jo, jr, _) = j_step(jst, actions[w])
        tst, (to, tr, _) = t_step(tst, torch.as_tensor(actions[w]))
        _eq(to, jo)
        _eq(tr, jr)


def test_plain_collect_v0_two_episodes_matches_jax_kernel():
    W, L, B, E = 35, 4, 8, 2
    rs = np.random.RandomState(2)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    actions = rs.randint(0, 16, size=(E * W, L, B)).astype(np.int32)
    jo, jr = make_beergame_collect_pallas(W, L, B, episodes=E, mode="actions",
                                          interpret=True)(demand, actions)
    to, tr = bgc.make_beergame_collect(W, L, B, episodes=E,
                                       mode="actions", device="cpu")(
        demand, actions)
    _eq(to, jo)
    _eq(tr, jr)


def test_plain_collect_v2_per_lane_delays_matches_jax_kernel():
    W, L, B, E, MAXD = 20, 4, 8, 2, 3
    rs = np.random.RandomState(5)
    demand = rs.randint(0, 12, size=(E * W, B)).astype(np.int32)
    delays = rs.randint(0, MAXD + 1, size=(E * W, B)).astype(np.int32)
    actions = rs.randint(0, 16, size=(E * W, L, B)).astype(np.int32)
    kw = dict(episodes=E, mode="actions", delay=None, max_delay=MAXD, **V2)
    jo, jr = make_beergame_collect_pallas(W, L, B, interpret=True, **kw)(
        demand, delays, actions)
    to, tr = bgc.make_beergame_collect(W, L, B, device="cpu", **kw)(demand, delays, actions)
    assert (delays == 0).any()
    _eq(to, jo)
    _eq(tr, jr)


def test_plain_collect_v2_scalar_delay_matches_jax_kernel():
    W, L, B = 15, 4, 8
    rs = np.random.RandomState(9)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    kw = dict(episodes=1, mode="actions", v2=True, max_stock=30,
              exceeded_capacity_penalty=11)
    jo, jr = make_beergame_collect_pallas(W, L, B, interpret=True, **kw)(
        demand, actions)
    to, tr = bgc.make_beergame_collect(W, L, B, device="cpu", **kw)(demand, actions)
    _eq(to, jo)
    _eq(tr, jr)


@pytest.mark.parametrize("per_lane", [False, True])
def test_random_equals_actions_on_philox_actions(per_lane):
    W, L, B, E, seed, max_order = 12, 4, 6, 3, 17, 16
    rs = np.random.RandomState(1)
    demand = rs.randint(0, 12, size=(E * W, B)).astype(np.int32)
    kw = dict(delay=None, max_delay=3) if per_lane else {}
    head = ([rs.randint(0, 4, size=(E * W, B)).astype(np.int32)]
            if per_lane else [])
    obs, rew = bgc.make_beergame_collect(W, L, B, episodes=E, mode="random",
                                         max_order=max_order, device="cpu",
                                         **kw)(
        demand, *head, seed)
    act = bgc.philox_actions(seed, range(E * W), L, max_order, B, "cpu")
    assert int(act.min()) >= 0 and int(act.max()) < max_order
    obs2, rew2 = bgc.make_beergame_collect(W, L, B, episodes=E,
                                           mode="actions", device="cpu",
                                           **kw)(
        demand, *head, act)
    assert torch.equal(obs, obs2) and torch.equal(rew, rew2)


def test_wrapper_checks():
    with pytest.raises(ValueError, match="power-of-two"):
        bgc.make_beergame_collect(35, 4, 8, mode="random", max_order=12)
    with pytest.raises(ValueError, match="max_delay"):
        bgc.make_beergame_collect(35, 4, 8, delay=None)
    demand = torch.zeros((35, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bgc.launch_beergame_collect(35, 4, 8, 1, "random", demand=demand)
    # a CPU collector takes no tensor from another device
    with pytest.raises(ValueError, match="collector on cpu"):
        bgc.make_beergame_collect(35, 4, 8, device="cpu")(demand.to("meta"), 0)
