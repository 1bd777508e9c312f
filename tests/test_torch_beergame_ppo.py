"""The port's beer-game learner against the JAX package's.

* ``discrete_forward`` and ``categorical_logp_entropy`` on JAX weights
  carried across by ``discrete_params_from_jax``: atol 1e-6 at O(1)
  scale (times max(1, max|x|): the log-probability summed over the 4
  levels is about -11, where float32's ulp is 1e-6).
* The beer-game PPO loss and its gradients on the same batch: rtol 1e-5
  (atol 1e-6 * max|g| for gradient entries near zero).
* The order-up-to policy on the same ``BeerGameState`` (v0 and v2, mid
  episode): bit-equal (integer arithmetic).
* ``beergame_base_stock_runner`` and ``make_beergame_evaluator`` on
  scripted tables (the same every episode in both packages): the returns
  are integer sums, exactly equal to JAX's.
* The port's form of ``test_beergame_ppo_learns``
  (``tests/test_vector_learn.py``) at its sizes and bar; the train CLI on
  the beer game, its checkpoint and exact resume; the comparison CLI.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu.core.beergame import (  # noqa: E402
    make_beergame_kernels as jax_kernels)
from gym_supplychain_tpu.learn.evaluate import (  # noqa: E402
    make_beergame_evaluator as j_evaluator)
from gym_supplychain_tpu.learn.heuristics import (  # noqa: E402
    beergame_base_stock_runner as j_runner,
    make_beergame_base_stock_policy as j_policy)
from gym_supplychain_tpu.models.policy import (  # noqa: E402
    MLPConfig as JMLPConfig,
    categorical_logp_entropy as j_logp_ent,
    discrete_forward as j_discrete_forward, init_discrete_actor_critic)

from gym_supplychain_tpu_torch.core.beergame import (  # noqa: E402
    make_beergame_kernels)
from gym_supplychain_tpu_torch.core.step import state_from_numpy  # noqa: E402
from gym_supplychain_tpu_torch.learn import (  # noqa: E402
    compare_baseline_beergame, evaluate, heuristics, ppo, train)
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    DiscreteActorCritic, MLPConfig, categorical_logp_entropy,
    discrete_forward, discrete_params_from_jax, params_to_numpy)
from gym_supplychain_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint)

L, N_CHOICES = 4, 16
V2 = dict(v2=True, max_stock=25, exceeded_capacity_penalty=37)


def _tree(hidden, seed, logit_scale=1.0):
    params = init_discrete_actor_critic(
        jax.random.PRNGKey(seed), JMLPConfig(L, L, tuple(hidden)), N_CHOICES,
        jnp.float32)
    params["logits"]["w"] = params["logits"]["w"] * logit_scale
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _batch(B, seed):
    rs = np.random.RandomState(seed)
    obs = rs.uniform(-1, 1, (L, B)).astype(np.float32)
    act = rs.randint(0, N_CHOICES, (L, B)).astype(np.int32)
    return obs, act


@pytest.mark.parametrize("hidden", [(32, 32), (16,), ()])
def test_discrete_forward_and_logp_entropy_match_jax(hidden):
    tree = _tree(hidden, 1, logit_scale=100.0)
    obs, act = _batch(24, 2)
    model = discrete_params_from_jax(tree, N_CHOICES, device="cpu")
    assert isinstance(model, DiscreteActorCritic)
    logits, v = discrete_forward(model, torch.from_numpy(obs), L, N_CHOICES)
    jlogits, jv = j_discrete_forward(tree, jnp.asarray(obs), L, N_CHOICES)
    assert logits.shape == (L, N_CHOICES, 24)
    logp, ent = categorical_logp_entropy(logits, torch.from_numpy(act))
    jlogp, jent = j_logp_ent(jlogits, jnp.asarray(act))
    for got, want in ((logits, jlogits), (v, jv), (logp, jlogp),
                      (ent, jent)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
    # the tree round-trips
    back = params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _j_loss(cfg, params, obs, act, old_logp, adv, ret):
    """``make_beergame_ppo``'s loss, as the JAX package writes it."""
    logits, value = j_discrete_forward(params, obs, L, N_CHOICES)
    logp, ent = j_logp_ent(logits, act)
    ratio = jnp.exp(logp - old_logp)
    pg = -jnp.minimum(ratio * adv,
                      jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv).mean()
    vf = 0.5 * ((value - ret) ** 2).mean()
    return pg + cfg.vf_coef * vf - cfg.ent_coef * ent.mean()


def test_beergame_loss_and_gradients_match_jax():
    hidden, M = (16, 16), 96
    tree = _tree(hidden, 3, logit_scale=30.0)
    obs, act = _batch(M, 4)
    jlogits, _ = j_discrete_forward(tree, jnp.asarray(obs), L, N_CHOICES)
    rs = np.random.RandomState(5)
    old = (np.asarray(j_logp_ent(jlogits, jnp.asarray(act))[0])
           + 0.3 * rs.randn(M)).astype(np.float32)
    adv = rs.randn(M).astype(np.float32)
    ret = rs.randn(M).astype(np.float32)
    data = (obs, act, old, adv, ret)
    cfg = ppo.PPOConfig(hidden=hidden, ent_coef=5e-3)
    want_loss, want = jax.value_and_grad(
        lambda p: _j_loss(cfg, p, *map(jnp.asarray, data)))(
        jax.tree.map(jnp.asarray, tree))
    _, step = ppo.make_beergame_ppo(8, cfg, device="cpu")
    model = discrete_params_from_jax(tree, N_CHOICES, device="cpu")
    loss, _ = step.loss(model, *map(torch.from_numpy, data))
    grads = torch.autograd.grad(loss, model.flat())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want_flat = []
    for layer in want["actor"]:
        want_flat += [layer["w"], layer["b"]]
    want_flat += [want["logits"]["w"], want["logits"]["b"]]
    for layer in want["critic"]:
        want_flat += [layer["w"], layer["b"]]
    want_flat += [want["v"]["w"], want["v"]["b"]]
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want_flat)
    for g, w in zip(grads, want_flat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("variant", ["v0", "v2"])
def test_base_stock_policy_matches_jax_bit_exact(variant):
    W, B, MAXD = 20, 8, 3
    kw = V2 if variant == "v2" else {}
    rs = np.random.RandomState(6)
    demand = rs.randint(0, 12, size=(W, B)).astype(np.int32)
    delays = np.concatenate([np.full((1, B), 2, np.int32),
                             rs.randint(0, MAXD + 1, size=(W, B))
                             .astype(np.int32)])
    j_reset, j_step, _ = jax_kernels(L, W, MAXD, itype=jnp.int32, **kw)
    _, t_step, _ = make_beergame_kernels(L, W, MAXD, device="cpu", **kw)
    jst = j_reset(demand, delays, [12] * L, 4, 4, B)
    jpol = j_policy(L, N_CHOICES, v2=variant == "v2")
    tpol = heuristics.make_beergame_base_stock_policy(L, N_CHOICES,
                                                      v2=variant == "v2")
    targets = (np.int32(20), np.array([30, 22, 14, 9], np.int32))
    for w in range(W - 1):
        tst = state_from_numpy({k: np.asarray(v) for k, v in
                                jst._asdict().items()}, device="cpu")
        for tgt in targets:
            want = np.asarray(jpol(jst, jnp.asarray(tgt)))
            got = tpol(tst, torch.as_tensor(tgt))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        jst, _ = j_step(jst, jpol(jst, jnp.asarray(targets[w % 2])))


SCRIPTED = dict(levels=L, weeks=35, max_order=N_CHOICES,
                customer_demand=[4] * 4 + [8] * 20 + [3] * 11,
                shipment_delays=3)


@pytest.mark.parametrize("v2", [True, False])
def test_base_stock_runner_matches_jax_on_scripted_tables(v2):
    B, episodes = 6, 2
    kw = dict(SCRIPTED, v2=v2, max_stock=30, exceeded_capacity_penalty=5)
    jrun = j_runner(B, episodes=episodes, **kw)
    run = heuristics.beergame_base_stock_runner(B, episodes=episodes,
                                                device="cpu", **kw)
    for target in (10, 24):
        jm, js = jrun(jnp.int32(target), jax.random.PRNGKey(0))
        m, s = run(target, 0)
        assert float(m) == float(jm) and float(s) == float(js)
    best, (m, _), scores = heuristics.best_beergame_base_stock(
        B, 0, targets=(10, 24), device="cpu", episodes=episodes, **kw)
    assert scores[best] == m == max(scores.values())


@pytest.mark.parametrize("hidden", [(16,), (8, 8)])
def test_beergame_evaluator_matches_jax_on_scripted_tables(hidden):
    B = 10
    tree = _tree(hidden, 7, logit_scale=300.0)     # well separated argmax
    kw = dict(SCRIPTED, v2=True)
    jstats = j_evaluator(B, **kw)(tree, jax.random.PRNGKey(3), 2)
    stats = evaluate.make_beergame_evaluator(B, device="cpu", **kw)(
        discrete_params_from_jax(tree, N_CHOICES, device="cpu"), 3, 2)
    assert set(stats) == set(jstats)
    for k in stats:
        assert float(stats[k]) == float(jstats[k]), k


def test_beergame_evaluator_redraws_ranges_per_episode():
    B = 64
    ev = evaluate.make_beergame_evaluator(
        B, customer_demand=(0, 12), shipment_delays=(0, 4), v2=True,
        device="cpu")
    model = DiscreteActorCritic(MLPConfig(L, L, (8,)), N_CHOICES,
                                torch.Generator().manual_seed(0), "cpu")
    one = ev(model, (5, 0), 1)
    two = ev(model, (5, 0), 2)
    again = ev(model, 5, 1)
    assert float(one["mean_return"]) == float(again["mean_return"])
    assert float(two["mean_return"]) != float(one["mean_return"])
    assert float(one["std_return"]) > 0


def test_beergame_ppo_learns():
    """Categorical PPO on the beer game improves the mean per-step reward
    by more than 60 over its first iterations (the JAX package's canary,
    same sizes)."""
    init_fn, train_step = ppo.make_beergame_ppo(
        128, ppo.PPOConfig(rollout_steps=36, hidden=(64,), lr=5e-3, epochs=4,
                           ent_coef=5e-3), device="cpu")
    state = init_fn(0)
    early, late = [], []
    for it in range(50):
        state, m = train_step(state)
        (early if it < 10 else late).append(float(m["mean_reward"]))
    assert np.mean(late[-10:]) > np.mean(early) + 60.0, (
        f"no learning: early={np.mean(early):.1f} "
        f"late={np.mean(late[-10:]):.1f}")


def test_beergame_trainer_refuses_the_continuous_options():
    with pytest.raises(ValueError, match="continuous"):
        ppo.make_beergame_ppo(8, ppo.PPOConfig(fused_update=True),
                              device="cpu")
    with pytest.raises(ValueError, match="float32"):
        ppo.make_beergame_ppo(8, ppo.PPOConfig(learner_dtype=torch.bfloat16),
                              device="cpu")


def _flat(params):
    return [p.detach().clone() for p in params.flat()]


def test_beergame_train_cli_resume_is_exact(tmp_path, capsys):
    argv = ["--env", "beergame-v2", "--envs", "8", "--hidden", "8",
            "--rollout-steps", "20", "--log-every", "1", "--device", "cpu",
            "--iters"]
    whole, m_whole = train.main(argv + ["4"])
    assert isinstance(whole.params, DiscreteActorCritic)
    ck = str(tmp_path / "ck")
    train.main(argv + ["2", "--checkpoint-dir", ck])
    out = capsys.readouterr().out
    assert "fused_collect=False fused_update=False" in out
    resumed, m_res = train.main(argv + ["2", "--restore", ck])
    assert float(m_res["loss"]) == float(m_whole["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_flat(resumed.params),
                                                 _flat(whole.params)))
    assert resumed.env.key == whole.env.key
    assert resumed.env.env.week == whole.env.env.week
    stored = restore_checkpoint(ck)
    assert isinstance(stored["params"], DiscreteActorCritic)
    assert stored["mlp"].hidden == (8,) and stored["params"].n_choices == 16


def test_compare_baseline_beergame_cli_prints_its_report(capsys):
    report = compare_baseline_beergame.main([
        "--envs", "4", "--iters", "2", "--rollout", "5", "--epochs", "1",
        "--hidden", "8", "--weeks", "6", "--eval-episodes", "1",
        "--targets", "8", "16", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == report
    assert set(report) == {"env", "weeks", "envs", "config", "order_up_to",
                           "ppo", "ppo_beats_order_up_to_by"}
    assert report["order_up_to"]["best_target"] in (8, 16)
    assert len(report["ppo"]["curve"]) == 2
