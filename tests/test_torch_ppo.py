"""The port's PPO learner against the JAX package's.

* The plain update gradients (autograd of the PyTorch ``_make_cont_loss``,
  what ``make_ppo_update_grads`` runs for CPU tensors) against
  ``jax.value_and_grad`` of the JAX loss and against the JAX kernel
  ``make_ppo_update_grads(interpret=True)``, at the sizes and tolerances of
  ``tests/test_ppo_update_pallas.py`` (loss 1e-5 relative, gradients rtol
  2e-5 and atol 2e-6 * max(1, max|g|)).
* GAE with dones inside the window: atol 1e-6 relative to the largest
  advantage.
* One ``_make_update`` (2 epochs, the ratio clip and the gradient clip both
  active) against the optax update from the same weights and data.
* The whole train step of ``make_ppo_fused`` on the same tables, through
  its phase hooks, against the JAX kernel collection and update.
* Smoke runs of both trainers and of the train CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.learn import ppo as jppo  # noqa: E402
from gym_supplychain_tpu.models.policy import (  # noqa: E402
    MLPConfig as JMLPConfig, actor_critic_forward as j_forward,
    init_actor_critic, tanh_gaussian_logp as j_logp)
from gym_supplychain_tpu.ops.ppo_update_pallas import (  # noqa: E402
    make_ppo_update_grads as j_update_grads)
from gym_supplychain_tpu.ops.supplychain_pallas import (  # noqa: E402
    make_supplychain_collect_pallas)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.learn import ppo, train  # noqa: E402
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    params_from_jax, params_to_numpy, sample_tanh_gaussian)
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402
from gym_supplychain_tpu_torch.ops.ppo_update import (  # noqa: E402
    fused_ppo_loss, make_ppo_update_grads)


def _tree(O, A, hidden, seed):
    params = init_actor_critic(jax.random.PRNGKey(seed),
                               JMLPConfig(O, A, tuple(hidden)), jnp.float32)
    # float32 leaves (with x64 on, the init's scaling promotes to float64)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _update_data(tree, O, A, M, seed, logp_noise=0.1):
    """Samples from the policy, old log-probs from a nearby policy (so the
    ratio clip has both branches live), normalized advantages."""
    rs = np.random.RandomState(seed)
    obs = rs.uniform(-1, 1, size=(O, M)).astype(np.float32)
    mu, log_std, _ = j_forward(tree, jnp.asarray(obs))
    pre = (np.asarray(mu) + np.exp(np.asarray(log_std))
           * rs.randn(A, M)).astype(np.float32)
    old = (np.asarray(j_logp(jnp.asarray(pre), mu, log_std))
           + logp_noise * rs.randn(M)).astype(np.float32)
    adv = rs.randn(M).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    ret = rs.randn(M).astype(np.float32)
    return obs, pre, old, adv, ret


def _leaves(tree):
    """A JAX parameter tree (or gradient tree) in the port's flat order."""
    flat = []
    for layer in tree["actor"]:
        flat += [layer["w"], layer["b"]]
    flat += [tree["mu"]["w"], tree["mu"]["b"]]
    for layer in tree["critic"]:
        flat += [layer["w"], layer["b"]]
    return flat + [tree["v"]["w"], tree["v"]["b"], tree["log_std"]]


def _close(got, want, rtol=2e-5, atol_scale=2e-6):
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_scale * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("O,A,hidden,M,tile,seed", [
    (9, 5, (16, 16), 128, 32, 0),
    (6, 3, (8,), 64, 64, 3),
])
@pytest.mark.parametrize("ref", ["autodiff", "pallas"])
def test_plain_update_grads_match_jax(O, A, hidden, M, tile, seed, ref):
    tree = _tree(O, A, hidden, seed)
    data = _update_data(tree, O, A, M, seed)
    kw = dict(clip=0.2, vf_coef=0.5, ent_coef=1e-3, pre_tanh_reg=1e-3)
    if ref == "autodiff":
        loss_fn = jppo._make_cont_loss(jppo.PPOConfig(hidden=hidden, **kw))
        want_loss, want = jax.value_and_grad(
            lambda p: loss_fn(p, *map(jnp.asarray, data))[0])(tree)
    else:
        want_loss, want = j_update_grads(O, A, hidden, M, tile=tile,
                                         interpret=True, **kw)(
            tree, *map(jnp.asarray, data))
    gf = make_ppo_update_grads(O, A, hidden, M, **kw)
    loss, grads = gf(params_from_jax(tree), *map(torch.from_numpy, data))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * max(
        1.0, abs(float(want_loss)))
    _close([g.numpy() for g in grads], _leaves(want))


def test_loss_function_hands_back_its_gradients():
    O, A, hidden, M = 6, 3, (8,), 64
    tree = _tree(O, A, hidden, 1)
    data = tuple(map(torch.from_numpy, _update_data(tree, O, A, M, 1)))
    gf = make_ppo_update_grads(O, A, hidden, M)
    model = params_from_jax(tree)
    loss = fused_ppo_loss(gf, model, data)
    (2.0 * loss).backward()
    fused = [p.grad.clone() for p in model.flat()]
    model.zero_grad()
    ref, _ = ppo._make_cont_loss(ppo.PPOConfig(hidden=hidden))(model, *data)
    (2.0 * ref).backward()
    assert torch.allclose(loss, ref, rtol=1e-6, atol=0)
    for g, p in zip(fused, model.flat()):
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="samples"):
        gf(model, *(d[..., :32] for d in data))


def test_gae_matches_jax_with_dones_inside():
    S, B = 12, 5
    rs = np.random.RandomState(4)
    rew, val = (rs.randn(S, B).astype(np.float32) for _ in range(2))
    last = rs.randn(B).astype(np.float32)
    done = np.zeros(S, bool)
    done[[3, 8]] = True
    kw = dict(gamma=0.97, lam=0.9)
    z = np.zeros((S, 1, B), np.float32)
    jt = jppo.Trajectory(obs=z, act_pre=z, logp=rew, reward=jnp.asarray(rew),
                         value=jnp.asarray(val), done=jnp.asarray(done))
    want_adv, want_ret = (np.asarray(x) for x in jppo._make_gae(
        jppo.PPOConfig(**kw))(jt, jnp.asarray(last)))
    tt = ppo.Trajectory(obs=None, act_pre=None, logp=None,
                        reward=torch.from_numpy(rew),
                        value=torch.from_numpy(val),
                        done=torch.from_numpy(done))
    adv, ret = ppo._make_gae(ppo.PPOConfig(**kw))(tt, torch.from_numpy(last))
    scale = np.abs(want_adv).max()
    np.testing.assert_allclose(adv.numpy(), want_adv, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ret.numpy(), want_ret, rtol=0, atol=1e-6 * scale)
    # the done steps cut the bootstrap: adv[3] is its own one-step delta
    np.testing.assert_allclose(adv.numpy()[3], rew[3] - val[3], atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.05, 1e6])
def test_clip_by_global_norm_matches_optax(max_norm):
    rs = np.random.RandomState(5)
    gs = [rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = torch.from_numpy(g.copy())
    ppo.clip_by_global_norm_(ps, max_norm)
    for p, w in zip(ps, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("minibatches,fused_update", [(1, False), (1, True),
                                                       (2, False)])
def test_update_matches_optax(minibatches, fused_update):
    O, A, hidden, S, B = 9, 5, (16, 16), 8, 16
    M = S * B
    kw = dict(hidden=hidden, epochs=2, lr=1e-3, max_grad_norm=0.05,
              minibatches=minibatches)
    tree = _tree(O, A, hidden, 2)
    obs, pre, old, adv, ret = _update_data(tree, O, A, M, 2, logp_noise=0.3)
    # [X, M] -> the sample-last [X, S, B] update layout (M = S*B time-major)
    data = (obs.reshape(O, S, B), pre.reshape(A, S, B), old.reshape(S, B),
            adv.reshape(S, B), ret.reshape(S, B))
    jcfg = jppo.PPOConfig(**kw)
    jloss = jppo._make_cont_loss(jcfg)
    # both clips are live on this data
    ratio = np.exp(np.asarray(j_logp(jnp.asarray(pre), *j_forward(
        tree, jnp.asarray(obs))[:2])) - old)
    assert ((ratio < 0.8) | (ratio > 1.2)).mean() > 0.1
    g = jax.grad(lambda p: jloss(p, *map(jnp.asarray, (obs, pre, old, adv,
                                                       ret)))[0])(tree)
    assert float(optax.global_norm(g)) > 2 * kw["max_grad_norm"]
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     optax.adam(jcfg.lr))
    jtree = jax.tree.map(jnp.asarray, tree)
    want, _, want_losses = jppo._make_update(jcfg, tx, jloss)(
        jtree, tx.init(jtree), tuple(map(jnp.asarray, data)))

    cfg = ppo.PPOConfig(**kw, fused_update=fused_update)
    model = params_from_jax(tree)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = ppo._make_update(cfg, ppo._make_cont_loss(cfg), dims=(O, A))(
        model, opt, tuple(map(torch.from_numpy, data)))
    assert losses.shape == (2 * minibatches,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=1e-5, atol=1e-6)
    got = [p.detach().numpy() for p in model.flat()]
    want = _leaves(jax.tree.map(np.asarray, want))
    for a, w in zip(got, want):
        # Adam moves each weight by about lr a step
        np.testing.assert_allclose(a, w, rtol=0, atol=2e-3 * cfg.lr)


def _jax_train_step(cc_j, tree, tables, T, B, E, hidden, cfg_kw):
    """The JAX fused train step (make_ppo_fused's body, table noise) on
    given tables: collection, GAE, normalization, update."""
    S = E * T
    dem, lt, eps = tables
    run = make_supplychain_collect_pallas(cc_j, T, B, mode="policy_eps",
                                          episodes=E, hidden=hidden,
                                          interpret=True, sample_major=True)
    tree = jax.tree.map(jnp.asarray, tree)
    args = (dem, lt, eps) if lt is not None else (dem, eps)
    obs, pre, logp, value, rew = run(*args, tree)
    done = (jnp.arange(S) % T) == T - 1
    cfg = jppo.PPOConfig(hidden=hidden, **cfg_kw)
    traj = jppo.Trajectory(obs=obs, act_pre=pre, logp=logp,
                           reward=rew * 1e-4, value=value, done=done)
    adv, ret = jppo._make_gae(cfg)(traj, jnp.zeros_like(value[-1]))
    advn = (adv - adv.mean()) / (adv.std() + 1e-8)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))
    params, _, losses = jppo._make_update(cfg, tx, jppo._make_cont_loss(cfg))(
        tree, tx.init(tree), (obs.reshape(cc_j.obs_dim, S, B),
                              pre.reshape(cc_j.A, S, B), logp, advn, ret))
    return (obs, pre, logp, value, rew), params, losses


@pytest.mark.filterwarnings("ignore:collect horizon")
def test_fused_train_step_matches_jax_on_the_same_tables():
    env_id, T, B, E, hidden = "supplychain-ntom-v0", 6, 4, 1, (8,)
    cfg_kw = dict(epochs=2, lr=1e-3)
    cc = make_chain(env_id, total_time_steps=T)
    init_fn, step = ppo.make_ppo_fused(
        cc, B, ppo.PPOConfig(hidden=hidden, **cfg_kw), episodes=E,
        noise="table")
    state = init_fn(11)
    with torch.no_grad():
        state.params.mu.w.mul_(100.0)          # non-degenerate actions
    tree = params_to_numpy(state.params)
    seed = step.draw_seed(state.gen)
    tables = scc.philox_tables(cc, seed, range(E * T), B, "cpu", policy=True)
    out = step.collect(state.params, seed)
    traj, data = step.prepare(*out)
    losses = step.update(state.params, state.opt, data, state.gen)

    want_out, want_params, want_losses = _jax_train_step(
        jsct.make(env_id, total_time_steps=T).cc, tree,
        [None if x is None else x.numpy() for x in tables], T, B, E, hidden,
        cfg_kw)
    want_out = [np.asarray(x) for x in want_out]
    np.testing.assert_allclose(out[0].numpy(), want_out[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[1].numpy(), want_out[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[2].numpy(), want_out[2], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(out[3].numpy(), want_out[3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[4].numpy(), want_out[4], rtol=0,
                               atol=1e-4 * np.abs(want_out[4]).max())
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=1e-4, atol=1e-6)
    p0 = np.concatenate([np.ravel(x) for x in _leaves(tree)]).astype(np.float64)
    got = np.concatenate([p.detach().numpy().ravel()
                          for p in state.params.flat()]) - p0
    want = np.concatenate([np.ravel(np.asarray(x)) for x in
                           _leaves(want_params)]) - p0
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.9999, cos
    assert traj.done.tolist() == [False] * (T - 1) + [True]


def _fused(env_id, T, B, hidden, episodes=1, **kw):
    cc = make_chain(env_id, total_time_steps=T)
    cfg = ppo.PPOConfig(hidden=hidden, epochs=2, lr=1e-3, **kw)
    return ppo.make_ppo_fused(cc, B, cfg, episodes=episodes, noise="table")


def test_fused_train_step_runs_and_updates():
    init_fn, train_step = _fused("supplychain-linear-v0", 8, 4, (16, 16))
    state = init_fn(0)
    p0 = [p.detach().clone() for p in state.params.flat()]
    losses = []
    for _ in range(3):
        state, metrics = train_step(state)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
        assert np.isfinite(float(metrics["mean_reward"]))
    # the optimizer moved the weights; iterations saw distinct trajectories
    assert any(not torch.allclose(a, b)
               for a, b in zip(p0, state.params.flat()))
    assert len({round(x, 10) for x in losses}) > 1


def test_fused_train_step_stochastic_multi_episode():
    init_fn, train_step = _fused("supplychain-ntom-v0", 6, 4, (8,),
                                 episodes=2, fused_update=True)
    state, metrics = train_step(init_fn(1))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["mean_value"]))


def test_fused_prng_and_table_noise_agree():
    cc = make_chain("supplychain-ntom-v0", total_time_steps=5)
    cfg = ppo.PPOConfig(hidden=(8,), epochs=1)
    got = []
    for noise in ("prng", "table"):
        init_fn, train_step = ppo.make_ppo_fused(cc, 3, cfg, noise=noise)
        _, metrics = train_step(init_fn(4))
        got.append({k: float(v) for k, v in metrics.items()})
    assert got[0] == got[1]
    with pytest.raises(ValueError, match="noise"):
        ppo.make_ppo_fused(cc, 3, cfg, noise="nope")


def test_scan_trainer_fused_update_moves_like_autograd():
    """make_ppo with and without fused_update from one state and rollout:
    the same loss and update direction (the JAX package's criterion)."""
    cc = make_chain("supplychain-ntom-v0", total_time_steps=6)
    kw = dict(rollout_steps=6, epochs=2, hidden=(8,))
    deltas, losses = [], []
    for fused in (False, True):
        init_fn, train_step = ppo.make_ppo(
            cc, 8, ppo.PPOConfig(**kw, fused_update=fused))
        state = init_fn(0)
        p0 = torch.cat([p.detach().reshape(-1) for p in state.params.flat()])
        state, metrics = train_step(state)
        p1 = torch.cat([p.detach().reshape(-1) for p in state.params.flat()])
        deltas.append((p1 - p0).double())
        losses.append(float(metrics["loss"]))
    assert abs(losses[1] - losses[0]) <= 1e-4 * max(1.0, abs(losses[0]))
    cos = float(deltas[0] @ deltas[1] / (deltas[0].norm() * deltas[1].norm()))
    assert cos > 0.9999, cos
    with pytest.raises(ValueError, match="continuous"):
        ppo._make_update(ppo.PPOConfig(fused_update=True), None)


def test_sample_tanh_gaussian_draws_from_its_density():
    g = torch.Generator().manual_seed(0)
    mu = torch.zeros(2, 20000)
    log_std = torch.full((2, 1), -1.0)
    act, logp = sample_tanh_gaussian(g, mu, log_std)
    assert act.shape == mu.shape and logp.shape == (20000,)
    assert bool((act.abs() < 1).all()) and bool(torch.isfinite(logp).all())
    assert abs(float(torch.atanh(act).std()) - np.exp(-1.0)) < 0.01


def test_train_cli_runs_the_scan_trainer_on_the_cpu(capsys):
    state, metrics = train.main(["--envs", "4", "--hidden", "8",
                                 "--horizon", "6", "--rollout-steps", "4",
                                 "--iters", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "fused_collect=False" in out and '"env_steps_per_s"' in out
    assert np.isfinite(float(metrics["loss"]))
    assert isinstance(state, ppo.TrainState)


@pytest.mark.parametrize("flags", [
    ["--multihost"], ["--model-axis", "2"], ["--checkpoint-dir", "ck"],
    ["--restore", "ck"], ["--trace-dir", "tr"], ["--learner-dtype", "bf16"],
    ["--env", "beergame-v0"]])
def test_train_cli_refuses_unported_flags(flags):
    with pytest.raises(SystemExit, match="not ported"):
        train.main(flags + ["--iters", "1"])
