"""Greedy policy evaluation (the serving path of the learner layer).

The counterpart of ``gym_supplychain_tpu/learn/evaluate.py``: greedy
``tanh(mu)`` rollouts of a trained actor-critic over whole fresh episodes,
reported as per-env episodic return statistics.  Two engines:

* ``make_evaluator``: the scan evaluator, a loop over the batched env of
  ``envs/vector.py`` (plain PyTorch, one Philox draw per step);
* ``make_fused_evaluator``: one launch of the greedy rollout kernel per
  episode (``ops/supplychain_episode.py``), fed whole-episode tables;
* ``make_beergame_evaluator``: greedy (argmax-logits) beer-game episodes of
  a ``make_beergame_ppo`` policy on the eager engine, fresh per-lane
  tables each episode.

Episode ``e`` of ``evaluate(params, key, episodes)`` plays the Philox
episode key ``(seed, n + e)`` for ``key = (seed, n)`` (a seed ``s`` is
``(s, 0)``) in both engines, and the fused evaluator's tables
(``rng.device.device_episode_tables``) hold the rows the scan evaluator's
env draws step by step, so the two see the same inputs.  Pairs with
``utils/checkpoint.py``:

    python -m gym_supplychain_tpu_torch.learn.evaluate --restore ckpt \\
        --env supplychain-ntom-v0 --envs 4096 --episodes 4

runs on the card (``--device cuda``, the default; an error where there is
none) with the kernel engine (``--engine kernel``, the JAX CLI's
``pallas``); ``--engine scan`` and ``--device cpu`` select the others.
The CLI evaluates the supply chains, as the JAX CLI does.
"""
from __future__ import annotations

import argparse

import torch

from ..core.compile import CompiledChain
from ..envs.vector import _as_key, beergame_table_config, make_vec_env
from ..models.policy import actor_critic_forward, discrete_forward
from ..utils.profiling import span

__all__ = ["make_evaluator", "make_fused_evaluator",
           "make_beergame_evaluator", "main"]


def _stats(per_env: torch.Tensor) -> dict:
    """Return statistics over ``[episodes, B]`` (population std, as
    ``jnp.std``)."""
    return {"mean_return": per_env.mean(),
            "std_return": per_env.std(correction=0),
            "min_return": per_env.min(),
            "max_return": per_env.max()}


def make_evaluator(cc: CompiledChain, batch_size: int, dtype=torch.float32,
                   device="cuda"):
    """Returns ``evaluate(params, key, episodes=1) -> {mean_return,
    std_return, min_return, max_return}`` of the per-env episodic return
    under the greedy (``tanh(mu)``) policy, stepping the batched env."""
    B = batch_size
    env_init, env_step, env_obs = make_vec_env(cc, B, dtype, device=device)

    @torch.no_grad()
    def evaluate(params, key, episodes: int = 1):
        st = env_init(key)
        obs = env_obs(st)
        rewards = torch.empty((episodes * cc.T, B), dtype=dtype,
                              device=obs.device)
        for s in range(episodes * cc.T):
            mu, _, _ = actor_critic_forward(params, obs)
            st, out = env_step(st, torch.tanh(mu))
            rewards[s] = out.reward
            obs = out.obs
        return _stats(rewards.reshape(episodes, cc.T, B).sum(dim=1))

    return evaluate


def make_fused_evaluator(cc: CompiledChain, batch_size: int,
                         hidden=(128, 128), device="cuda", draw_tables=None):
    """Greedy evaluation through the greedy rollout kernel: per episode,
    draw the tables, run ``run_policy`` (observation, actor and env step in
    one launch) and sum the rewards.

    ``hidden`` must match the parameters' trunk widths.  ``draw_tables(
    ep_key) -> (demands [T+1,R,P,B], leadtimes [T,K,B] or None)`` replaces
    the default ``device_episode_tables`` draw (a test feeds another
    package's tables through it).  On the CPU the plain episode runner
    runs.  Returns ``evaluate(params, key, episodes=1) -> stats`` like
    ``make_evaluator``.
    """
    from ..ops.supplychain_episode import make_supplychain_policy_rollout
    from ..rng.device import device_episode_tables

    B = batch_size
    run_policy = make_supplychain_policy_rollout(cc, cc.T, B,
                                                 hidden=tuple(hidden),
                                                 device=device)
    if draw_tables is None:
        def draw_tables(ep_key):
            return device_episode_tables(ep_key, cc, B, device=device)

    @torch.no_grad()
    def evaluate(params, key, episodes: int = 1):
        with span("evaluate"):
            seed, n = _as_key(key)
            per_env = []
            for e in range(episodes):
                demands, leadtimes = draw_tables((seed, n + e))
                lt = [leadtimes] if cc.stochastic_leadtimes else []
                per_env.append(run_policy(demands, *lt, params).sum(dim=0))
            return _stats(torch.stack(per_env))

    return evaluate


def make_beergame_evaluator(batch_size: int, levels: int = 4,
                            weeks: int = 35, max_order: int = 16,
                            customer_demand=None, shipment_delays=2,
                            v2: bool = False, max_stock: int = 100,
                            exceeded_capacity_penalty: int = 100,
                            dtype=torch.float32, device="cuda"):
    """Greedy (argmax-logits) evaluation of a ``make_beergame_ppo`` policy:
    whole fresh episodes, the tables re-drawn per episode (the v2 ranges,
    or scripted tables), the trainer's observation scale.  Episode ``e`` of
    ``evaluate(params, key, episodes)`` draws its tables under the Philox
    key ``(seed, n + e)`` for ``key = (seed, n)`` (a seed ``s`` is ``(s,
    0)``).  Returns ``evaluate(params, key, episodes=1) -> {mean_return,
    std_return, min_return, max_return}`` of the per-env episodic return.
    """
    from ..core.beergame import make_beergame_kernels

    B, L = batch_size, levels
    tables = beergame_table_config(weeks, customer_demand, shipment_delays,
                                   device)
    weeks, draw = tables["weeks"], tables["draw"]
    reset_k, step_k, obs_k = make_beergame_kernels(
        L, weeks, tables["max_delay"], v2=v2, max_stock=max_stock,
        exceeded_capacity_penalty=exceeded_capacity_penalty,
        itype=torch.int32, device=device)
    obs_scale = 1.0 / (4.0 * tables["max_demand"])   # as make_beergame_ppo
    inv0 = [12] * L

    @torch.no_grad()
    def evaluate(params, key, episodes: int = 1):
        seed, n = _as_key(key)
        per_env = []
        for e in range(episodes):
            st = reset_k(*draw((seed, n + e), B), inv0, 4, 4, B)
            ret = torch.zeros((B,), dtype=torch.float32, device=device)
            for _ in range(weeks):
                obs = obs_k(st).to(dtype) * obs_scale
                logits, _ = discrete_forward(params, obs, L, max_order)
                st, (_, r, _) = step_k(st, torch.argmax(logits, dim=1))
                ret += r.to(torch.float32)
            per_env.append(ret)
        return _stats(torch.stack(per_env))

    return evaluate


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="supplychain-ntom-v0")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--episodes", type=int, default=4)
    p.add_argument("--horizon", type=int, default=360)
    p.add_argument("--restore", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", choices=("scan", "kernel"), default="kernel",
                   help="kernel = the greedy rollout kernel (the JAX CLI's "
                        "pallas); scan = the batched env loop")
    p.add_argument("--hidden", type=int, nargs="+", default=None,
                   help="trunk widths; default: the checkpoint's (must match "
                        "it when given)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error where there is no card) or "
                        "cpu")
    args = p.parse_args(argv)
    from .train import device_from_flag

    if args.env.startswith("beergame"):
        raise SystemExit(f"--env {args.env}: the evaluate CLI evaluates the "
                         "supply chains, as the JAX package's does; evaluate "
                         "a beer-game policy with learn.evaluate."
                         "make_beergame_evaluator")
    device = device_from_flag(args.device)

    from .. import make_chain
    from ..utils.checkpoint import restore_checkpoint

    cc = make_chain(args.env, total_time_steps=args.horizon)
    ckpt = restore_checkpoint(args.restore)
    params = ckpt["params"].to(device)
    hidden = ckpt["mlp"].hidden
    if args.hidden is not None and tuple(args.hidden) != hidden:
        raise SystemExit(f"--hidden {args.hidden}: the checkpoint's trunk is "
                         f"{list(hidden)}")
    if args.engine == "kernel":
        evaluate = make_fused_evaluator(cc, args.envs, hidden, device=device)
    else:
        evaluate = make_evaluator(cc, args.envs, device=device)
    stats = {k: float(v) for k, v in
             evaluate(params, args.seed, args.episodes).items()}
    print(stats)
    return stats


if __name__ == "__main__":
    main()
