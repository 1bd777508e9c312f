"""Trained-policy vs order-up-to comparison for the beer game family.

The counterpart of ``gym_supplychain_tpu/learn/compare_baseline_beergame.py``,
with the same flags and JSON report, plus ``--device``: grid-tunes the
scripted order-up-to target (``learn/heuristics.py``, an oracle-state
baseline), trains PPO on the stochastic v2 variant (the reference v2's
demand and delay ranges by default) with ``make_beergame_ppo``,
greedy-evaluates the policy periodically (``make_beergame_evaluator``) and
at the end, and prints the report.

    python -m gym_supplychain_tpu_torch.learn.compare_baseline_beergame \\
        --envs 256 --iters 2000
"""
from __future__ import annotations

import argparse
import json
import time


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--rollout", type=int, default=35)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--ent", type=float, default=5e-3)
    p.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    p.add_argument("--weeks", type=int, default=35)
    p.add_argument("--max-order", type=int, default=16)
    p.add_argument("--dem-range", type=int, nargs=2, default=[0, 12])
    p.add_argument("--delay-range", type=int, nargs=2, default=[0, 4])
    p.add_argument("--max-stock", type=int, default=100)
    p.add_argument("--penalty", type=int, default=100)
    p.add_argument("--eval-episodes", type=int, default=8)
    p.add_argument("--eval-every", type=int, default=0,
                   help="greedy-eval period in iters (0 = iters//10)")
    p.add_argument("--targets", type=int, nargs="+",
                   default=list(range(4, 41, 2)))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error where there is no card) or "
                        "cpu")
    return p


def env_kwargs(args):
    """The beer game's ``make_beergame_ppo`` / evaluator keywords of the
    parsed flags."""
    return dict(levels=4, weeks=args.weeks, max_order=args.max_order,
                customer_demand=tuple(args.dem_range),
                shipment_delays=tuple(args.delay_range), v2=True,
                max_stock=args.max_stock,
                exceeded_capacity_penalty=args.penalty)


def main(argv=None):
    args = parser().parse_args(argv)
    from .train import device_from_flag

    device = device_from_flag(args.device)

    import torch

    from .evaluate import make_beergame_evaluator
    from .heuristics import best_beergame_base_stock
    from .ppo import PPOConfig, make_beergame_ppo

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    kw = env_kwargs(args)

    t0 = time.time()
    best_s, (heur, heur_std), scores = best_beergame_base_stock(
        args.envs, args.seed, targets=args.targets,
        episodes=args.eval_episodes, device=device, **kw)
    grid_s = time.time() - t0

    cfg = PPOConfig(rollout_steps=args.rollout, hidden=tuple(args.hidden),
                    lr=args.lr, epochs=args.epochs, ent_coef=args.ent)
    init_fn, train_step = make_beergame_ppo(args.envs, cfg, device=device,
                                            **kw)
    state = init_fn(args.seed)
    evaluate = make_beergame_evaluator(args.envs, device=device, **kw)

    every = args.eval_every or max(1, args.iters // 10)
    t0 = time.time()
    eval_s = 0.0
    curve = []
    for it in range(args.iters):
        state, m = train_step(state)
        if (it + 1) % every == 0:
            te = time.time()
            stats = evaluate(state.params, args.seed + 1, args.eval_episodes)
            eval_s += time.time() - te
            curve.append({
                "iter": it + 1,
                "greedy_mean_return": round(float(stats["mean_return"]), 1),
                "mean_step_reward": round(float(m["mean_reward"]), 1)})
    sync()
    train_s = time.time() - t0 - eval_s

    stats = evaluate(state.params, args.seed + 1, args.eval_episodes)
    trained = float(stats["mean_return"])
    improvement = (trained - heur) / abs(heur)

    report = {
        "env": "beergame-v2-stochastic", "weeks": args.weeks,
        "envs": args.envs,
        "config": {"demand_range": args.dem_range,
                   "delay_range": args.delay_range,
                   "max_stock": args.max_stock, "penalty": args.penalty,
                   "max_order": args.max_order},
        "order_up_to": {"best_target": best_s, "mean_return": round(heur, 1),
                        "std_return": round(heur_std, 1),
                        "grid": {str(k): round(v, 1)
                                 for k, v in scores.items()},
                        "grid_seconds": round(grid_s, 1)},
        "ppo": {"iters": args.iters, "train_seconds": round(train_s, 1),
                "greedy_mean_return": round(trained, 1),
                "greedy_std_return": round(float(stats["std_return"]), 1),
                "curve": curve},
        "ppo_beats_order_up_to_by": f"{improvement:.1%}",
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
