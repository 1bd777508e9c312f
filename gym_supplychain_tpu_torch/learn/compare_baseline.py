"""Trained-policy vs scripted-baseline comparison for the supply-chain family.

The counterpart of ``gym_supplychain_tpu/learn/compare_baseline.py``, with
the same flags and JSON report, plus ``--device``: grid-searches the
base-stock multiplier (``learn/heuristics.py``), trains PPO with the scan
trainer (``make_ppo``), greedy-evaluates the trained policy on fresh
episodes with the scan evaluator (``make_evaluator``), and prints the
report.

    python -m gym_supplychain_tpu_torch.learn.compare_baseline \\
        --env sc-2perstage-v0 --horizon 60 --envs 256 --iters 400
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="sc-2perstage-v0")
    p.add_argument("--horizon", type=int, default=60)
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    p.add_argument("--eval-episodes", type=int, default=4)
    p.add_argument("--zs", type=float, nargs="+",
                   default=[0.5, 1.0, 1.5, 2.0, 2.5, 3.0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error where there is no card) or "
                        "cpu")
    args = p.parse_args(argv)
    from .train import device_from_flag

    device = device_from_flag(args.device)

    import torch

    from .. import make_chain
    from .evaluate import make_evaluator
    from .heuristics import best_base_stock
    from .ppo import PPOConfig, make_ppo

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cc = make_chain(args.env, total_time_steps=args.horizon)

    t0 = time.time()
    z, heur, scores = best_base_stock(cc, args.envs, args.seed, zs=args.zs,
                                      episodes=args.eval_episodes,
                                      device=device)
    grid_s = time.time() - t0

    cfg = PPOConfig(rollout_steps=args.rollout, hidden=tuple(args.hidden),
                    lr=args.lr, epochs=args.epochs)
    init_fn, train_step = make_ppo(cc, args.envs, cfg, device=device)
    state = init_fn(args.seed)
    evaluate = make_evaluator(cc, args.envs, device=device)
    # periodic greedy evaluations in the curve: the sampled rollout's
    # mean_step_reward moves with the exploration noise
    every = max(1, args.iters // 10)
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
        "env": args.env, "horizon": args.horizon, "envs": args.envs,
        "base_stock": {"best_z": z, "mean_return": round(heur, 1),
                       "grid": {str(k): round(v, 1) for k, v in scores.items()},
                       "grid_seconds": round(grid_s, 1)},
        "ppo": {"iters": args.iters, "train_seconds": round(train_s, 1),
                "greedy_mean_return": round(trained, 1),
                "greedy_std_return": round(float(stats["std_return"]), 1),
                "curve": curve},
        "ppo_beats_base_stock_by": f"{improvement:.1%}",
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
