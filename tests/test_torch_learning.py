"""The port learns as the JAX package learns.

CPU part (tier-1; the JAX package imported inside each test):

* ``make_ppo_fused(noise="table")`` against the JAX fused trainer (the
  collect kernel in interpret mode, GAE, normalization and the optax update)
  over 5 consecutive iterations, each side carrying its own parameters and
  optimizer state, both fed the same Philox tables: after every iteration
  the cumulative parameter change has cosine >= 0.999 against JAX's, the
  mean reward agrees within 1e-4 relative and the update's losses within
  1e-4 relative (atol 1e-6), with the port's update by autograd and by the
  update kernel's plain version;
* ``make_ppo`` (the scan trainer) against the JAX scan trainer over 5
  iterations of rollouts that cross episode ends, JAX's env in table mode
  fed the port's episode tables and both fed the port's noise: the same
  checks;
* ``make_ppo(fused_update=True)`` (the update kernel's plain version)
  against ``make_ppo(fused_update=False)`` (autograd) over 5 iterations from
  one seed: cumulative parameter change cosine >= 0.999, loss and mean
  reward within 1e-4 relative;
* each learning bar's compare-CLI run (``learn/bars.py``) at a tiny size
  on the CPU (its code path, not its margin), and the compare CLI's fused
  engine.

Card part (marked ``cuda``; skips without a card): the JAX package's four
learning bars of ``tests/test_vector_learn.py`` at their sizes, iteration
counts, hyperparameters, baseline grids and margins, run through the
port's compare CLIs as ``learn/bars.py`` gives them, at seed 0 on
``--device cuda``, and the sc-2perstage bar on the fused engine (K1
``policy`` collection with the update kernel, float32 and bf16), gated at
beating the tuned base stock, its margin printed against the scan bar's
5%.  The card part imports no jax:

    python -m pytest tests/test_torch_learning.py -m cuda --noconftest -v -s
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.learn import bars, ppo  # noqa: E402
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    params_to_numpy)
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402

ITERS = 5                       # consecutive iterations held against JAX
COS, RTOL, ATOL = 0.999, 1e-4, 1e-6
EVAL_RTOL = 1e-5                # the kernel evaluator against the scan one


def _flat(params):
    return np.concatenate([p.detach().cpu().numpy().ravel()
                           for p in params.flat()]).astype(np.float64)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _jax_leaves(tree):
    """A JAX parameter tree in the port's flat order, as one float64
    vector (``test_torch_ppo.py``'s ``_leaves``, whose module imports jax
    when it loads; this one's card tests run without jax)."""
    flat = []
    for layer in tree["actor"]:
        flat += [layer["w"], layer["b"]]
    flat += [tree["mu"]["w"], tree["mu"]["b"]]
    for layer in tree["critic"]:
        flat += [layer["w"], layer["b"]]
    flat += [tree["v"]["w"], tree["v"]["b"], tree["log_std"]]
    return np.concatenate([np.ravel(np.asarray(x)) for x in flat]).astype(
        np.float64)


def _jax_fused_trainer(env_id, T, B, hidden, cfg_kw, tree):
    """The JAX fused trainer's iteration (``make_ppo_fused``'s body with
    table noise) carrying its parameters and optax state: ``step(tables)
    -> (mean reward, losses)``; ``state["params"]`` is the current tree."""
    import jax
    import jax.numpy as jnp
    import optax

    import gym_supplychain_tpu as jsct
    from gym_supplychain_tpu.learn import ppo as jppo
    from gym_supplychain_tpu.ops.supplychain_pallas import (
        make_supplychain_collect_pallas)

    cc = jsct.make(env_id, total_time_steps=T).cc
    run = make_supplychain_collect_pallas(cc, T, B, mode="policy_eps",
                                          episodes=1, hidden=hidden,
                                          interpret=True, sample_major=True)
    cfg = jppo.PPOConfig(hidden=hidden, **cfg_kw)
    gae = jppo._make_gae(cfg)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))
    update = jax.jit(jppo._make_update(cfg, tx, jppo._make_cont_loss(cfg)))
    done = jnp.arange(T) == T - 1
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt": tx.init(params)}

    def step(tables):
        dem, lt, eps = (None if x is None else jnp.asarray(x.numpy())
                        for x in tables)
        args = (dem, lt, eps) if lt is not None else (dem, eps)
        obs, pre, logp, value, rew = run(*args, state["params"])
        traj = jppo.Trajectory(obs=obs, act_pre=pre, logp=logp,
                               reward=rew * 1e-4, value=value, done=done)
        adv, ret = gae(traj, jnp.zeros_like(value[-1]))
        advn = (adv - adv.mean()) / (adv.std() + 1e-8)
        data = (obs.reshape(cc.obs_dim, T, B), pre.reshape(cc.A, T, B),
                logp, advn, ret)
        state["params"], state["opt"], losses = update(
            state["params"], state["opt"], data)
        return float(jnp.mean(rew)), np.asarray(losses)

    return step, state


@pytest.mark.filterwarnings("ignore:collect horizon")
@pytest.mark.parametrize("fused_update", [False, True])
def test_fused_trainer_learns_as_jax_over_five_iterations(fused_update):
    """The card's default engine (fused collection; the update by autograd
    or by the update kernel's plain version) against the JAX fused trainer
    on the same tables, iteration after iteration."""
    env_id, T, B, hidden = "supplychain-ntom-v0", 6, 4, (8,)
    cfg_kw = dict(epochs=2, lr=1e-3)
    cc = make_chain(env_id, total_time_steps=T)
    init_fn, step = ppo.make_ppo_fused(
        cc, B, ppo.PPOConfig(hidden=hidden, fused_update=fused_update,
                             **cfg_kw),
        noise="table", device="cpu")
    state = init_fn(11)
    with torch.no_grad():
        state.params.mu.w.mul_(100.0)          # non-degenerate actions
    tree = params_to_numpy(state.params)
    jstep, jstate = _jax_fused_trainer(env_id, T, B, hidden, cfg_kw, tree)
    p0 = _jax_leaves(tree)
    for it in range(ITERS):
        seed = step.draw_seed(state.gen)
        tables = scc.philox_tables(cc, seed, range(T), B, "cpu", policy=True)
        traj, data = step.prepare(*step.collect(state.params, seed))
        losses = step.update(state.params, state.opt, data, state.gen)
        reward = float(traj.reward.mean() / 1e-4)
        want_reward, want_losses = jstep(tables)
        assert abs(reward - want_reward) <= RTOL * abs(want_reward), (
            it, reward, want_reward)
        np.testing.assert_allclose(losses.numpy(), want_losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"iteration {it}")
        cos = _cos(_flat(state.params) - p0,
                   _jax_leaves(jstate["params"]) - p0)
        assert cos >= COS, (it, cos)


def test_update_kernel_plain_learns_as_autograd_over_five_iterations():
    """``make_ppo`` with the update kernel's plain version against
    autograd, 5 iterations from one seed: the same draws, so the runs part
    only by the update's rounding."""
    cc = make_chain("supplychain-ntom-v0", total_time_steps=6)
    kw = dict(rollout_steps=6, epochs=2, hidden=(8,))
    runs = []
    for fused in (False, True):
        init_fn, train_step = ppo.make_ppo(
            cc, 4, ppo.PPOConfig(**kw, fused_update=fused), device="cpu")
        state = init_fn(0)
        p0 = _flat(state.params)
        rows = []
        for _ in range(ITERS):
            state, m = train_step(state)
            rows.append((_flat(state.params) - p0, float(m["loss"]),
                         float(m["mean_reward"])))
        runs.append(rows)
    for it, (a, b) in enumerate(zip(*runs)):
        assert _cos(a[0], b[0]) >= COS, (it, _cos(a[0], b[0]))
        for x, y in zip(a[1:], b[1:]):
            assert abs(x - y) <= RTOL * abs(x), (it, x, y)


# ---------------------------------------------------------------------------
# The learning bars (tests/test_vector_learn.py) through the compare CLIs
# ---------------------------------------------------------------------------

# each bar's code path at a tiny size: horizon 6, 4 envs, 2 iterations
TINY = {"sc-2perstage": ("sc2perstage", ()), "ntom": ("ntom", ()),
        "seasonal": ("seasonal", ()), "beergame": ("beergame", ()),
        "fused": ("sc2perstage", ("--engine", "fused")),
        "fused-bf16": ("sc2perstage", ("--engine", "fused",
                                       "--learner-dtype", "bf16"))}


def _baseline(report):
    return report["base_stock" if "base_stock" in report else "order_up_to"]


def _report(name, report):
    base = _baseline(report)
    print(f"\n{name}: trained {report['ppo']['greedy_mean_return']:.1f}, "
          f"baseline {base['mean_return']:.1f} (grid optimum "
          f"{base.get('best_z', base.get('best_target'))}), margin "
          f"{bars.margin(report):.2%}; grid {base['grid']}")


@pytest.mark.parametrize("bar", list(TINY))
def test_learning_bars_run_on_the_cpu(bar):
    """Each bar's CLI run at a tiny size (horizon 6, 4 envs, 2
    iterations): finite returns, the grid's optimum among its points, and
    the fused engine's two evaluators on the same inputs."""
    name, engine = TINY[bar]
    tiny = (("--envs", "4", "--iters", "2", "--eval-episodes", "1")
            if name == "beergame" else
            ("--horizon", "6", "--envs", "4", "--iters", "2", "--grid-envs",
             "4"))
    report = bars.run(name, *tiny, *engine, "--device", "cpu")
    base, run = _baseline(report), report["ppo"]
    if engine:
        assert run["kernel_vs_scan_relative"] <= EVAL_RTOL
    assert np.isfinite(run["greedy_mean_return"])
    assert np.isfinite(base["mean_return"])
    assert base["mean_return"] == max(base["grid"].values())
    assert len(run["curve"]) == 2 and np.isfinite(bars.margin(report))


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_compare_cli_trains_the_fused_engine_on_the_cpu(dtype, capsys):
    """``compare_baseline --engine fused``: the card's default engine in the
    report, with the greedy rollout kernel's return beside the scan
    evaluator's on the same episodes."""
    import json

    from gym_supplychain_tpu_torch.learn import compare_baseline

    report = compare_baseline.main(
        ["--horizon", "5", "--envs", "4", "--iters", "2", "--hidden", "8",
         "--eval-episodes", "1", "--zs", "0.5", "1.0", "--device", "cpu",
         "--engine", "fused"] + (["--learner-dtype", dtype] if dtype else []))
    assert json.loads(capsys.readouterr().out) == report
    run = report["ppo"]
    assert (run["engine"], run["learner_dtype"]) == ("fused",
                                                     dtype or "float32")
    assert run["kernel_vs_scan_relative"] <= EVAL_RTOL
    assert abs(run["kernel_greedy_mean_return"]
               - run["greedy_mean_return"]) <= 0.1
    assert len(run["curve"]) == 2


def _card_bar(name, *extra):
    """The bar's CLI run on the card at seed 0, its report."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels)")
    report = bars.run(name, *extra, "--device", "cuda")
    _report(f"{name} {' '.join(extra)}", report)
    return report


@pytest.mark.cuda
def test_supplychain_ppo_beats_base_stock():
    """sc-2perstage-v0, T = 60: 220 iterations beat base stock at z = 2.0
    (the grid optimum) by >= 5%."""
    report = _card_bar("sc2perstage")
    assert bars.passes("sc2perstage", report), bars.margin(report, 2.0)


@pytest.mark.cuda
def test_ntom_ppo_matches_tuned_base_stock():
    """supplychain-ntom-v0, T = 60: 500 iterations at lr 3e-4 beat the
    grid-tuned base stock (128 envs, 2 episodes) by >= 0.2%."""
    report = _card_bar("ntom")
    assert bars.passes("ntom", report), bars.margin(report)


@pytest.mark.cuda
def test_seasonal_ppo_beats_base_stock():
    """sc-2perstage-seasonal-v0, T = 60: the grid's optimum is interior and
    800 iterations beat it by >= 8%."""
    report = _card_bar("seasonal")
    assert bars.interior(report), _baseline(report)
    assert bars.passes("seasonal", report), bars.margin(report)


@pytest.mark.cuda
def test_beergame_ppo_beats_order_up_to():
    """beergame-v2 on its stochastic ranges: the order-up-to grid's optimum
    is interior and 1500 iterations beat it by >= 2%."""
    report = _card_bar("beergame")
    assert bars.interior(report), _baseline(report)
    assert bars.passes("beergame", report), bars.margin(report)


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["float32", "bf16"])
def test_fused_engine_beats_tuned_base_stock(learner):
    """The card's default engine on the sc-2perstage bar (K1 ``policy``
    collection, the update kernel in float32 or bf16, 220 one-episode
    iterations, the same net and lr): the greedy rollout kernel and the
    scan evaluator agree within 1e-5 and the policy beats the tuned base
    stock (the scan trainer's 5% is printed beside its margin, not held)."""
    from gym_supplychain_tpu_torch.utils.profiling import (counters,
                                                           reset_counters)

    reset_counters()
    report = _card_bar("sc2perstage", "--engine", "fused",
                       *(["--learner-dtype", "bf16"] if learner == "bf16"
                         else []))
    counted = counters()
    launches = {k: counted.get("launch." + k, 0)
                for k in ("supplychain_policy", "ppo_update",
                          "ppo_update_bf16", "ppo_update_bf16_mma",
                          "supplychain_greedy")}
    run = report["ppo"]
    print(f"  against the scan bar's 5% over z = 2.0: "
          f"{bars.margin(report, 2.0):.2%}; greedy rollout kernel "
          f"{run['kernel_greedy_mean_return']:.1f}; launches {launches}")
    assert run["kernel_vs_scan_relative"] <= EVAL_RTOL
    update = (launches["ppo_update"] if learner == "float32"
              else launches["ppo_update_bf16"]
              + launches["ppo_update_bf16_mma"])
    assert launches["supplychain_policy"] == 220 and update == 4 * 220
    assert launches["supplychain_greedy"] == 1
    assert bars.margin(report) > 0, report


def _jax_scan_trainer(env_id, T, B, cfg_kw, tree):
    """The JAX scan trainer (``make_ppo``'s rollout body, GAE, update)
    carrying its parameters and optax state, with its env in table mode
    and its noise given: ``step(env, obs, eps [S, A, B], next_tables) ->
    (env, obs, mean reward, losses)``; ``next_tables()`` gives the tables
    of the episode an auto-reset starts."""
    import jax
    import jax.numpy as jnp
    import optax

    import gym_supplychain_tpu as jsct
    from gym_supplychain_tpu.core.step import make_supplychain_kernels
    from gym_supplychain_tpu.learn import ppo as jppo
    from gym_supplychain_tpu.models.policy import (actor_critic_forward,
                                                   tanh_gaussian_logp)

    cc = jsct.make(env_id, total_time_steps=T).cc
    reset_k, step_k, obs_k = make_supplychain_kernels(cc)
    step_k, forward = jax.jit(step_k), jax.jit(actor_critic_forward)
    cfg = jppo.PPOConfig(**cfg_kw)
    gae = jppo._make_gae(cfg)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))
    update = jax.jit(jppo._make_update(cfg, tx, jppo._make_cont_loss(cfg)))
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt": tx.init(params)}

    def reset(tables):
        return reset_k(*(None if x is None else jnp.asarray(x.numpy())
                         for x in tables), B)

    def step(env, obs, eps, next_tables):
        rows = []
        for e in eps:
            mu, log_std, value = forward(state["params"], obs)
            pre = mu + jnp.exp(log_std) * jnp.asarray(e.numpy())
            env, out = step_k(env, jnp.tanh(pre))
            rows.append(jppo.Trajectory(
                obs=obs, act_pre=pre,
                logp=tanh_gaussian_logp(pre, mu, log_std),
                reward=out.reward * 1e-4, value=value, done=out.done))
            obs = out.obs
            if bool(out.done):
                env = reset(next_tables())
                obs = obs_k(env)
        traj = jax.tree.map(lambda *x: jnp.stack(x), *rows)
        _, _, last_value = forward(state["params"], obs)
        adv, ret = gae(traj, last_value)
        state["params"], state["opt"], losses = update(
            state["params"], state["opt"], jppo._flatten_traj(traj, adv, ret))
        return env, obs, float(traj.reward.mean() / 1e-4), np.asarray(losses)

    return step, reset, obs_k, state


def test_scan_trainer_learns_as_jax_over_five_iterations():
    """``make_ppo`` (the scan trainer) against the JAX scan trainer over 5
    iterations of 4-step rollouts through 6-step episodes (auto-resets
    inside a rollout, rollouts that end mid-episode), both fed the port's
    episode tables and exploration noise: the checks of the fused test."""
    from gym_supplychain_tpu_torch.rng.device import device_episode_tables

    env_id, T, B, S = "supplychain-ntom-v0", 6, 4, 4
    cfg_kw = dict(rollout_steps=S, epochs=2, lr=1e-3, hidden=(8,))
    cc = make_chain(env_id, total_time_steps=T)
    init_fn, train_step = ppo.make_ppo(cc, B, ppo.PPOConfig(**cfg_kw),
                                       device="cpu")
    state = init_fn(3)
    with torch.no_grad():
        state.params.mu.w.mul_(100.0)          # non-degenerate actions
    tree = params_to_numpy(state.params)
    jstep, jreset, jobs, jstate = _jax_scan_trainer(env_id, T, B, cfg_kw,
                                                    tree)
    seed, n = state.env.key                    # episode (seed, n - 1) runs
    episodes = iter(range(n, n + ITERS * S))

    def tables(k):
        return device_episode_tables((seed, k), cc, B, device="cpu")

    env = jreset(tables(n - 1))
    obs = jobs(env)
    p0 = _jax_leaves(tree)
    for it in range(ITERS):
        noise = torch.Generator().set_state(state.gen.get_state())
        eps = [torch.randn((cc.A, B), generator=noise) for _ in range(S)]
        state, m = train_step(state)
        env, obs, want_reward, want_losses = jstep(
            env, obs, eps, lambda: tables(next(episodes)))
        reward = float(m["mean_reward"])
        assert abs(reward - want_reward) <= RTOL * abs(want_reward), (
            it, reward, want_reward)
        np.testing.assert_allclose(float(m["loss"]), want_losses[-1],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"iteration {it}")
        cos = _cos(_flat(state.params) - p0,
                   _jax_leaves(jstate["params"]) - p0)
        assert cos >= COS, (it, cos)
