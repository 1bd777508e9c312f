"""Time the host-bound trainers of one tree on the card: the beer game's
trainer and ``make_ppo_fused`` with the update kernel.

    python3 tools/time_trainers.py [--tree DIR] [--label NAME] [--iters 10]

Imports ``gym_supplychain_tpu_torch`` from DIR (by default the checkout
this script lies in), so that two trees, such as a commit and its parent
unpacked with ``git archive``, are timed by the same code.  Run each tree
in a process of its own, in turns (parent, change, change, parent), on one
card: both trainers are host-bound, so a time taken once on a busy host
says little.

The shapes are ``chip_smoke.py``'s: the beer game's trainer of phase 14
(c) (beergame-v2, demand [0, 12), delays [0, 4), 4096 envs, hidden (64,
64), a 35-week rollout, 4 epochs) and the trainer of phase 8 (ntom, 4096
envs, horizon 60, hidden (128, 128), epochs 2, the fused update).  Each is
timed over ``--iters`` iterations after two warm ones, each iteration
between host clocks ending in a sync (median ms).  Prints the card's name
and power limit, then one JSON line: the label, the tree and each
trainer's ms an iteration.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _timed(step, state, iters: int) -> float:
    import torch

    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t = time.perf_counter()
        state, _ = step(state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="tree")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the trainers are timed on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.learn import ppo

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out = {"label": args.label, "tree": args.tree}
    cfg = ppo.PPOConfig(rollout_steps=35, epochs=4, hidden=(64, 64))
    init_fn, step = ppo.make_beergame_ppo(
        4096, cfg, v2=True, customer_demand=(0, 12), shipment_delays=(0, 4),
        device="cuda")
    out["beergame_ms"] = _timed(step, init_fn(0), args.iters)
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=60)
    cfg = ppo.PPOConfig(epochs=2, hidden=(128, 128), fused_update=True)
    init_fn, step = ppo.make_ppo_fused(cc, 4096, cfg, device="cuda")
    out["fused_ms"] = _timed(step, init_fn(0), args.iters)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
