"""The lane-group env step on the small chains: K1 beside K5.

Times trajectory collection in ``random`` mode on ``supplychain-linear-v0``
and ``supplychain-ntom-v0`` (Philox inputs, auto-reset, obs every step) at
``--envs`` environments and ``--episodes`` back-to-back episodes a call,
through two entry points on the same seed:

* ``collect``: ``make_supplychain_collect``, the collect kernel K1;
* ``dense``: ``make_supplychain_dense_collect``, the dense collect kernel
  K5 at its fixed 16 lanes an env and 8 envs a block.

Both draw the same Philox words and step the same dynamics, so their
observations must agree bit for bit (``max_abs_obs_diff``); their rewards
sum the costs in other orders.  For each: ms a call (CUDA events, median of
``--reps`` after a warm-up) and us a step.  Needs a CUDA device; prints one
JSON object with the card's name and power limit.

    python -m gym_supplychain_tpu_torch.benchmarks.lane_groups [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .. import make_chain
from ..ops import supplychain_collect as scc
from ..ops import supplychain_dense as scd
from .large_topologies import _timed

CHAINS = ("supplychain-linear-v0", "supplychain-ntom-v0")


def run_benchmark(B: int = 4096, episodes: int = 8, reps: int = 5,
                  seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the lane-group benchmark times the CUDA kernels: "
                           "no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
           "B": B, "episodes": episodes,
           "protocol": f"median of {reps} after a warm-up, CUDA events"}
    for env_id in CHAINS:
        cc = make_chain(env_id)
        S = episodes * cc.T
        runs = {
            "collect": scc.make_supplychain_collect(
                cc, cc.T, B, mode="random", episodes=episodes, device=dev),
            "dense": scd.make_supplychain_dense_collect(
                cc, cc.T, B, mode="random", episodes=episodes, device=dev),
        }
        res, obs = {"S": S}, {}
        for name, run in runs.items():
            ms, (o, _) = _timed(lambda: run(seed), reps, dev)
            res[name] = {"ms": ms, "us_a_step": 1e3 * ms / S}
            obs[name] = o
        res["max_abs_obs_diff"] = float(
            (obs["collect"] - obs["dense"]).abs().max())
        out[env_id] = res
        del obs
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = run_benchmark(args.envs, args.episodes, args.reps, args.seed)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    res = main()
    sys.exit(0 if all(res[c]["max_abs_obs_diff"] == 0.0 for c in CHAINS)
             else 1)
