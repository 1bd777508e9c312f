"""The base-stock policy's mean episodic return under the port's episode
draw and under the JAX package's, on the CPU, over many keys: whether the
two packages' scoring episodes come from one distribution.

    python3 tools/base_stock_parity.py [--env supplychain-ntom-v0]
        [--horizon 60] [--envs 4096] [--episodes 2] [--keys 40] [--z 0.03]

Each key k (100, 101, ...) runs ``evaluate_state_policy`` at base stock
``z`` on ``--envs`` envs for ``--episodes`` episodes: the port's on its
keys (``device="cpu"``), the JAX package's on ``PRNGKey(k)`` in float32.
Prints one JSON line: each package's mean over the keys and its standard
error, and their difference.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="supplychain-ntom-v0")
    p.add_argument("--horizon", type=int, default=60)
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--episodes", type=int, default=2)
    p.add_argument("--keys", type=int, default=40)
    p.add_argument("--z", type=float, default=0.03)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np

    import gym_supplychain_tpu as jsct
    from gym_supplychain_tpu.learn import heuristics as jh
    from gym_supplychain_tpu_torch import make_chain
    from gym_supplychain_tpu_torch.learn import heuristics as ph

    jax.config.update("jax_enable_x64", False)
    jcc = jsct.make(args.env, total_time_steps=args.horizon).cc
    pcc = make_chain(args.env, total_time_steps=args.horizon)
    keys = range(100, 100 + args.keys)
    runs = {
        "port": [float(ph.evaluate_state_policy(
            pcc, args.envs, ph.default_base_stock_targets(pcc, args.z), k,
            episodes=args.episodes, device="cpu")) for k in keys],
        "jax": [float(jh.evaluate_state_policy(
            jcc, args.envs, jh.default_base_stock_targets(jcc, args.z),
            jax.random.PRNGKey(k), episodes=args.episodes)) for k in keys]}
    out = {"args": vars(args)}
    for name, r in runs.items():
        r = np.array(r)
        out[name] = {"mean": r.mean(), "se": r.std() / np.sqrt(len(r))}
    out["port_minus_jax"] = out["port"]["mean"] - out["jax"]["mean"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
