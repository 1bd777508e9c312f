"""The port's actor-critic and the collect kernel's policy modes, against the
JAX package.

* ``actor_critic_forward`` and ``tanh_gaussian_logp`` on JAX weights carried
  across by ``params_from_jax``: atol 1e-6.
* The plain ``policy_eps`` collection (what the wrapper runs for CPU
  tensors) against ``make_supplychain_collect_pallas(mode="policy_eps",
  interpret=True)`` at the sizes and tolerances of
  ``tests/test_pallas_collect.py`` (obs atol 1e-6, pre 1e-4, logp rtol 1e-4
  atol 1e-3, value 1e-4, rewards 1e-4 * max|r|).
* ``policy`` equals ``policy_eps`` on the Philox tables, and
  ``sample_major`` is the default layout, reshaped (bit for bit).

The CUDA kernel itself is held against the plain version on the card
(``chip_smoke.py``, ``tests/test_torch_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.models.policy import (  # noqa: E402
    MLPConfig as JMLPConfig, actor_critic_forward as j_forward,
    init_actor_critic, tanh_gaussian_logp as j_logp)
from gym_supplychain_tpu.ops.supplychain_pallas import (  # noqa: E402
    _box_muller, make_supplychain_collect_pallas)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    ActorCritic, MLPConfig, actor_critic_forward, params_from_jax,
    params_to_numpy, tanh_gaussian_logp)
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402
from gym_supplychain_tpu_torch.ops._mlp import (  # noqa: E402
    LAYOUT_INTS, SMEM_MAX, MlpLayout)
from gym_supplychain_tpu_torch.ops.supplychain_dense import (  # noqa: E402
    dense_descriptor, lane_block, policy_block)
from gym_supplychain_tpu_torch.rng.device import box_muller  # noqa: E402


def _jax_params(O, A, hidden, seed, mu_scale=1.0):
    params = init_actor_critic(jax.random.PRNGKey(seed),
                               JMLPConfig(O, A, tuple(hidden)), jnp.float32)
    params["mu"]["w"] = params["mu"]["w"] * mu_scale
    # float32 leaves (with x64 on, the init's scaling promotes to float64)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


@pytest.mark.parametrize("hidden", [(16, 16), (8,)])
def test_forward_and_logp_match_jax(hidden):
    O, A, B = 9, 5, 32
    tree = _jax_params(O, A, hidden, seed=3, mu_scale=50.0)
    rs = np.random.RandomState(0)
    obs = rs.uniform(-1, 1, size=(O, B)).astype(np.float32)
    model = params_from_jax(tree, device="cpu")
    mu, log_std, v = actor_critic_forward(model, torch.from_numpy(obs))
    jmu, jls, jv = (np.array(x) for x in j_forward(tree, jnp.asarray(obs)))
    np.testing.assert_allclose(mu.detach().numpy(), jmu, rtol=0,
                               atol=1e-6 * max(1, np.abs(jmu).max()))
    np.testing.assert_allclose(log_std.detach().numpy(), jls, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(v.detach().numpy(), jv, rtol=0, atol=1e-6)
    pre = (jmu + np.exp(jls) * rs.randn(A, B)).astype(np.float32)
    lp = tanh_gaussian_logp(torch.from_numpy(pre), torch.from_numpy(jmu),
                            torch.from_numpy(jls))
    jlp = np.asarray(j_logp(jnp.asarray(pre), jnp.asarray(jmu),
                            jnp.asarray(jls)))
    np.testing.assert_allclose(lp.numpy(), jlp, rtol=0,
                               atol=1e-6 * max(1, np.abs(jlp).max()))
    # the same module called directly
    mu2, _, v2 = model(torch.from_numpy(obs))
    assert torch.equal(mu, mu2) and torch.equal(v, v2)


def test_params_round_trip_and_flat_order():
    tree = _jax_params(7, 3, (8, 4), seed=1)
    model = params_from_jax(tree, device="cpu")
    back = params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # _flat_actor_critic: actor (w, b) pairs, mu, critic pairs, v, log_std
    shapes = [tuple(p.shape) for p in model.flat()]
    assert shapes == [(8, 7), (8, 1), (4, 8), (4, 1), (3, 4), (3, 1),
                      (8, 7), (8, 1), (4, 8), (4, 1), (1, 4), (1, 1), (3, 1)]
    assert {id(p) for p in model.flat()} == {id(p) for p in model.parameters()}
    # a seed gives the same weights, the init's scales hold
    m1 = ActorCritic(MLPConfig(7, 3, (8,)), torch.Generator().manual_seed(5),
                      device="cpu")
    m2 = ActorCritic(MLPConfig(7, 3, (8,)), torch.Generator().manual_seed(5),
                      device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m1.flat(), m2.flat()))
    assert float(m1.mu.w.detach().abs().max()) < 0.1
    assert bool((m1.log_std == -0.5).all())


def test_box_muller_matches_jax():
    rs = np.random.RandomState(2)
    u1, u2 = (rs.rand(4096).astype(np.float32) for _ in range(2))
    u1[0] = 0.0                                    # the edge of [0, 1)
    got = box_muller(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    want = np.asarray(_box_muller(jnp.asarray(u1), jnp.asarray(u2)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert abs(got.mean()) < 0.1 and abs(got.std() - 1) < 0.05


def _policy_tables(cc, T, B, seed):
    rs = np.random.RandomState(seed)
    demands = rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    eps = rs.randn(T, cc.A, B).astype(np.float32)
    lt = (rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B)).astype(np.int32)
          if cc.stochastic_leadtimes else None)
    return demands, lt, eps


@pytest.mark.parametrize("env_id,T,B,hidden,seed", [
    ("supplychain-linear-v0", 15, 4, (16, 16), 1),
    ("supplychain-ntom-v0", 10, 4, (16,), 2),
])
def test_plain_policy_eps_matches_jax_kernel(env_id, T, B, hidden, seed):
    cc = jsct.make(env_id, total_time_steps=T).cc
    tree = _jax_params(cc.obs_dim, cc.A, hidden, seed, mu_scale=100.0)
    demands, lt, eps = _policy_tables(cc, T, B, seed)
    jax_run = make_supplychain_collect_pallas(cc, T, B, mode="policy_eps",
                                              hidden=hidden, interpret=True)
    jargs = (demands, eps, tree) if lt is None else (demands, lt, eps, tree)
    want = [np.asarray(x) for x in jax_run(*jargs)]
    run = scc.make_supplychain_collect(cc, T, B, mode="policy_eps",
                                       hidden=hidden, device="cpu")
    # the port takes S-row tables: row T only feeds the terminal obs
    args = (demands[:T], eps) if lt is None else (demands[:T], lt, eps)
    obs, pre, logp, value, rew = (x.numpy()
                                  for x in run(*args, params_from_jax(tree, device="cpu")))
    assert obs.shape == (T, cc.obs_dim, B) and pre.shape == (T, cc.A, B)
    np.testing.assert_allclose(obs, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pre, want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(logp, want[2], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(value, want[3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rew, want[4], rtol=0,
                               atol=1e-4 * np.abs(want[4]).max())


@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_policy_equals_policy_eps_on_philox_tables(env_id):
    T, B, E, seed, hidden = 6, 5, 2, 2 ** 40 + 3, (8,)
    cc = make_chain(env_id, total_time_steps=T)
    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, hidden),
                        torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.mu.w.mul_(100.0)
    out = scc.make_supplychain_collect(cc, T, B, mode="policy", episodes=E,
                                       hidden=hidden, device="cpu")(model,
                                                                    seed)
    dem, lt, eps = scc.philox_tables(cc, seed, range(E * T), B, "cpu",
                                     policy=True)
    args = [dem] + ([lt] if cc.stochastic_leadtimes else []) + [eps]
    out2 = scc.make_supplychain_collect(cc, T, B, mode="policy_eps",
                                        episodes=E, hidden=hidden,
                                        device="cpu")(*args, model)
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    # the noise rows are standard normals; a step's rows depend on the step
    assert abs(float(eps.mean())) < 0.3
    assert not torch.equal(out[1][:T], out[1][T:])


def test_sample_major_layout_matches_default():
    T, B, E, hidden = 6, 8, 2, (16,)
    S = E * T
    cc = make_chain("supplychain-ntom-v0", total_time_steps=T)
    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, hidden),
                        torch.Generator().manual_seed(1), device="cpu")
    kw = dict(mode="policy", episodes=E, hidden=hidden, device="cpu")
    od, ad, ld, vd, rd = scc.make_supplychain_collect(cc, T, B, **kw)(model, 7)
    os_, as_, ls, vs, rs_ = scc.make_supplychain_collect(
        cc, T, B, sample_major=True, **kw)(model, 7)
    assert torch.equal(od.permute(1, 0, 2).reshape(cc.obs_dim, S * B), os_)
    assert torch.equal(ad.permute(1, 0, 2).reshape(cc.A, S * B), as_)
    assert torch.equal(ld, ls) and torch.equal(vd, vs) and torch.equal(rd, rs_)


def test_mlp_layout_packs_transposed_padded_weights():
    model = ActorCritic(MLPConfig(5, 3, (12, 6)),
                        torch.Generator().manual_seed(2), device="cpu")
    lay = MlpLayout(5, 3, (12, 6))
    packed = lay.pack(model.flat())
    assert packed.numel() == sum(lay.wsec) and lay.wsec[0] % 8 == 0
    flat = model.flat()
    for net, rows in enumerate(lay.layers):
        base = 0 if net == 0 else lay.wsec[0]
        for l, (K, J, Jp, w_off, b_off, gw_off, gb_off) in enumerate(rows):
            w, b = flat[(net * (lay.nL + 1) + l) * 2:][:2]
            wt = packed[base + w_off:base + w_off + K * Jp].view(K, Jp)
            assert torch.equal(wt[:, :J], w.detach().t())
            assert not wt[:, J:].any()
            assert torch.equal(packed[base + b_off:base + b_off + J],
                               b.detach().reshape(-1))
            # gradient offsets follow the flat order within the net
            off = sum(p.numel() for p in flat[net * (2 * lay.nL + 2):]
                      [:2 * l])
            assert (gw_off, gb_off) == (off, off + J * K)
    assert torch.equal(packed[lay.ls_woff:lay.ls_woff + 3],
                       model.log_std.detach().reshape(-1))
    assert lay.n_params == sum(p.numel() for p in flat)
    views = lay.unflat_grads(torch.arange(lay.P, dtype=torch.float32), flat)
    assert [tuple(v.shape) for v in views] == [tuple(p.shape) for p in flat]
    assert float(views[-1][-1, 0]) == lay.n_params - 1


def test_policy_collect_rejects_what_it_does_not_take():
    cc = make_chain("supplychain-linear-v0", total_time_steps=3)
    with pytest.raises(ValueError, match="hidden"):
        scc.make_supplychain_collect(cc, 3, 2, mode="policy")
    with pytest.raises(ValueError, match="sample_major"):
        scc.make_supplychain_collect(cc, 3, 2, mode="random",
                                     sample_major=True)
    with pytest.raises(NotImplementedError):
        scc.make_supplychain_collect(cc, 3, 2, mode="greedy")
    with pytest.raises(NotImplementedError):        # more than 4 layers
        MlpLayout(cc.obs_dim, cc.A, (8,) * 5)
    with pytest.raises(NotImplementedError):        # over the shared memory
        policy_block(cc, MlpLayout(cc.obs_dim, cc.A, (256, 256)), 4096, 2)
    ntom = make_chain("supplychain-ntom-v0")
    assert policy_block(ntom, MlpLayout(27, 14, (128, 128)), 4096,
                        2)[3] + 4 * LAYOUT_INTS <= 232448
    # a CPU collector takes no parameters from another device
    run = scc.make_supplychain_collect(cc, 3, 2, mode="policy", hidden=(4,),
                                       device="cpu")
    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, (4,)),
                        device="cpu").to("meta")
    with pytest.raises(ValueError, match="collector on cpu"):
        run(model, 0)
    # a CPU launch never reaches the kernel
    desc = torch.as_tensor(dense_descriptor(cc))
    lay = MlpLayout(cc.obs_dim, cc.A, (4,))
    with pytest.raises(ValueError, match="CUDA"):
        scc.launch_supplychain_policy(desc, cc, lay,
                                      torch.as_tensor(lay.ints), None, 3, 2,
                                      "policy")


@pytest.mark.parametrize("nets", [1, 2])
@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0",
                                    "supplychain-2perstage-v0"])
def test_policy_block_fits_the_trainer_widths(env_id, nets):
    """The policy lane kernel's plan at hidden (128, 128): ``lane_block``'s
    lanes, an odd stretch of the collect stretch plus the action, and the
    weights of ``nets`` networks, the tiles and E stretches within a
    block's shared memory at every E it picks."""
    cc = make_chain(env_id)
    lay = MlpLayout(cc.obs_dim, cc.A, (128, 128))
    G_lane, _, lane_stride, _ = lane_block(cc, "collect")
    for B in (4096, 1024, 4096 + 7, 5):
        G, E, stride, smem = policy_block(cc, lay, B, nets)
        assert G == G_lane and stride % 2 == 1
        assert abs(stride - cc.A - lane_stride) <= 1
        assert smem == 4 * (sum(lay.wsec[:nets]) + E * (
            2 * 128 + sum(lay.head_rows[:nets]) + stride))
        assert smem + 4 * LAYOUT_INTS <= SMEM_MAX == 232448
    with pytest.raises(NotImplementedError, match="beyond"):
        policy_block(cc, MlpLayout(cc.obs_dim, cc.A, (256, 256)), 4096,
                     nets)


@pytest.mark.parametrize("B,E", [(4096, 32), (4096 + 7, 32), (4065, 32),
                                 (4064, 16), (2048, 16), (2033, 16),
                                 (2032, 8), (1024, 8), (3, 8)])
def test_policy_block_envs_follow_the_batch(B, E):
    """E is the largest of 32, 16 and 8 that still makes 128 blocks of B
    envs (one weight copy an SM at B = 4096), else 8; the actor and the
    actor-critic plan alike."""
    cc = make_chain("supplychain-ntom-v0")
    lay = MlpLayout(cc.obs_dim, cc.A, (128, 128))
    assert policy_block(cc, lay, B, 1)[1] == policy_block(cc, lay, B,
                                                          2)[1] == E
    # 16 lanes an env (N*P = 18): at most 16 envs, 256 threads a block
    big = make_chain("sc-Nperstage-multiproduct-v0",
                     nodes_per_echelon=[2, 3, 2, 2], num_products=2)
    lay16 = MlpLayout(big.obs_dim, big.A, (128, 128))
    assert policy_block(big, lay16, B, 1)[:2] == (16, min(E, 16))
    with pytest.raises(ValueError, match="nets"):
        policy_block(cc, lay, B, 3)
    with pytest.raises(ValueError, match="O="):
        policy_block(cc, MlpLayout(cc.obs_dim + 1, cc.A, (8,)), B, 1)
