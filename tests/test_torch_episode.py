"""Episode kernel (K4/K6a): its plain version against the JAX kernel.

The plain version (``supplychain_episode_plain``, what the runners use for
CPU tensors) must reproduce ``make_supplychain_episode_pallas(...,
interpret=True)``'s ``run_actions`` and
``make_supplychain_policy_rollout_pallas(..., interpret=True)`` at the sizes
and tolerance of ``tests/test_pallas_ops.py``: rewards atol 1e-4 * max|r|.
On 2perstage (processing ratio 3) XLA:CPU's reciprocal rewrites make the two
differ by a few float32 ulps (ROADMAP Queue 3), well inside that tolerance.
JAX's ``seeded`` draws from the TPU's PRNG, which interpret mode lacks, so
the port's ``seeded`` is held equal to ``actions`` on its Philox rows.  The
CUDA kernels are compared with the plain version on the card
(``chip_smoke.py`` phase 9, ``tests/test_torch_kernels.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.models.policy import (  # noqa: E402
    MLPConfig as JMLPConfig, init_actor_critic)
from gym_supplychain_tpu.ops.supplychain_pallas import (  # noqa: E402
    make_supplychain_episode_pallas, make_supplychain_policy_rollout_pallas)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.models.policy import params_from_jax  # noqa: E402
from gym_supplychain_tpu_torch.ops import supplychain_episode as sce  # noqa: E402
from gym_supplychain_tpu_torch.ops._mlp import (  # noqa: E402
    LAYOUT_INTS, MlpLayout)

CASES = [("supplychain-linear-v0", 20, 8, (32, 32), 1),
         ("supplychain-ntom-v0", 15, 4, (16,), 2),
         ("supplychain-2perstage-v0", 12, 4, (16,), 3)]


def _tables(cc, T, B, seed):
    rs = np.random.RandomState(seed)
    dem = rs.randint(0, 30, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    lt = (rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B)).astype(np.int32)
          if cc.stochastic_leadtimes else None)
    act = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    act[act < -0.5] = -1.0              # some supplies must not fire
    return [dem] + ([lt] if lt is not None else []), act


def _tree(cc, hidden, seed):
    params = init_actor_critic(jax.random.PRNGKey(seed),
                               JMLPConfig(cc.obs_dim, cc.A, hidden))
    # non-degenerate mu head (the init scale 0.01 makes actions ~0)
    params["mu"]["w"] = params["mu"]["w"] * 100
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("env_id,T,B,hidden,seed", CASES)
def test_plain_actions_matches_jax_kernel(env_id, T, B, hidden, seed):
    cc = jsct.make(env_id, total_time_steps=T).cc
    tables, act = _tables(cc, T, B, seed)
    _, j_actions = make_supplychain_episode_pallas(cc, T, B, interpret=True)
    _, run_actions = sce.make_supplychain_episode(cc, T, B, device="cpu")
    _close(run_actions(*tables, act), j_actions(*tables, act))


@pytest.mark.parametrize("env_id,T,B,hidden,seed", CASES)
def test_plain_policy_matches_jax_kernel(env_id, T, B, hidden, seed):
    cc = jsct.make(env_id, total_time_steps=T).cc
    tables, _ = _tables(cc, T, B, seed)
    tree = _tree(cc, hidden, seed)
    j_policy = make_supplychain_policy_rollout_pallas(cc, T, B, hidden=hidden,
                                                      interpret=True)
    run_policy = sce.make_supplychain_policy_rollout(cc, T, B, hidden=hidden,
                                                     device="cpu")
    got = run_policy(*tables, params_from_jax(tree, device="cpu"))
    _close(got, j_policy(*tables, tree))


@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_seeded_equals_actions_on_philox_rows(env_id):
    T, B, seed = 9, 5, 2 ** 35 + 11
    cc = make_chain(env_id, total_time_steps=T)
    tables, _ = _tables(cc, T, B, 4)
    run_seeded, run_actions = sce.make_supplychain_episode(cc, T, B,
                                                           device="cpu")
    act = sce.seeded_actions(cc, seed, B, "cpu")
    assert act.shape == (T, cc.A, B)
    assert bool(((act >= -1) & (act < 1)).all())
    assert torch.equal(run_seeded(*tables, seed), run_actions(*tables, act))
    assert not torch.equal(run_seeded(*tables, seed),
                           run_seeded(*tables, seed + 1))


def test_runners_check_what_they_take():
    cc = make_chain("supplychain-ntom-v0", total_time_steps=4)
    with pytest.raises(ValueError):                  # T != cc.T
        sce.make_supplychain_episode(cc, 5, 2, device="cpu")
    with pytest.raises(ValueError):
        sce.make_supplychain_episode(cc, 4, 2, device="meta")
    bad = cc.__class__(**{**cc.__dict__,
                          "stock_cap": -np.asarray(cc.stock_cap)})
    with pytest.raises(ValueError):                  # negative capacities
        sce.dense_descriptor(bad)
    with pytest.raises(NotImplementedError):         # over the shared memory
        sce.policy_block(cc, MlpLayout(cc.obs_dim, cc.A, (256, 256)), 4096, 1)
    assert sce.policy_block(cc, MlpLayout(27, 14, (128, 128)), 4096,
                            1)[3] + 4 * LAYOUT_INTS <= 232448
    # a CPU launch never reaches the kernel
    desc = torch.as_tensor(sce.dense_descriptor(cc))
    (dem, lt), act = _tables(cc, 4, 2, 0)
    with pytest.raises(ValueError, match="CUDA"):
        sce.launch_supplychain_episode(desc, cc, 2, "actions",
                                       torch.from_numpy(dem),
                                       torch.from_numpy(lt),
                                       torch.from_numpy(act))
    # a CPU runner takes no tensor from another device
    _, run_actions = sce.make_supplychain_episode(cc, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="runner on cpu"):
        run_actions(torch.from_numpy(dem).to("meta"), lt, act)


def test_tables_carry_normal_and_seasonal_demand():
    """The episode modes read demand from tables, so a seasonal chain (no
    in-kernel draw) runs, and ``seeded`` needs no uniform demand."""
    cc = jsct.make("sc-2perstage-seasonal-v0", total_time_steps=6).cc
    B = 3
    (dem,), act = _tables(cc, 6, B, 5)
    run_seeded, run_actions = sce.make_supplychain_episode(cc, 6, B,
                                                           device="cpu")
    rew = run_seeded(dem * 10, 7)
    assert rew.shape == (6, B) and bool(torch.isfinite(rew).all())
    assert torch.equal(rew, run_actions(dem * 10,
                                        sce.seeded_actions(cc, 7, B, "cpu")))
