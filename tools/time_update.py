"""Time the fused PPO update kernel (K2), float32 and bf16, on the card.

    python3 tools/time_update.py [--tree DIR] [--label NAME]
        [--env supplychain-ntom-v0] [--hidden 128 128] [--envs 4096]
        [--horizon 60] [--calls 20] [--turns 3] [--seed 0]

Imports ``gym_supplychain_tpu_torch`` from DIR (by default the checkout
this script lies in), so that two trees, such as a commit and its parent
unpacked with ``git archive``, are timed by the same code.  Run each tree
in a process of its own, in turns (parent, change, change, parent), on one
card.

Both modes go through the public entry, ``make_ppo_update_grads``, at M =
horizon x envs samples of the env's obs and action widths, with phase 7's
inputs of ``chip_smoke.py`` (a policy whose mu head is scaled by 100, old
log-probs of a nearby policy, normalized advantages).  Two yardsticks, each
``--calls`` calls enqueued without a sync and timed by CUDA events, in
turns (float32, bf16, bf16, float32), ``--turns`` times:

* ``sleep``: behind a sleep kernel, so that the host is ahead of the card
  and the time is the card's alone;
* ``plain``: no sleep, so that the first call's enqueue counts in.

Prints the shape and each mode's bound (also without a card), the card's
name and power limit, then one JSON line: the label, the tree, the shape,
the bounds, and per mode and yardstick the card's ms a call (each turn
and the median) and the host's ms to enqueue a call.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLEEP_CYCLES = 200_000_000  # ~0.1 s on the card: longer than the enqueue
PEAK_FLOPS = {"float32": 67e12, "bf16": 989e12}  # H100 SXM, data sheet
PEAK_BYTES = 3.35e12                             # H100 SXM HBM3 bytes/s


def _bound(O, A, hidden, M):
    """The least ms of one K2 call of each mode, as ``chip_smoke.py`` counts
    it: the larger of its bytes (inputs read once, the weights read and the
    gradients written) over the memory rate and its products' operations
    (forward, weight and input gradients, none into the obs) over the
    mode's peak."""
    dims = [O, *hidden]
    macs = sum(K * J for K, J in zip(dims, dims[1:])) * 2
    macs += hidden[-1] * (A + 1)
    params = macs + 2 * sum(hidden) + A + 1 + A
    flops = 2 * M * (3 * macs - 2 * O * hidden[0])
    n_bytes = 4 * (M * (O + A + 3) + 2 * params)
    t_bytes = 1e3 * n_bytes / PEAK_BYTES
    return {mode: dict(gflop=round(flops / 1e9, 3), mb=round(n_bytes / 1e6, 2),
                       bytes_ms=round(t_bytes, 5),
                       ops_ms=round(1e3 * flops / peak, 5),
                       bound_ms=round(max(t_bytes, 1e3 * flops / peak), 5))
            for mode, peak in PEAK_FLOPS.items()}


def _inputs(model, O, A, M, seed, dev):
    import torch
    from gym_supplychain_tpu_torch.models.policy import (
        actor_critic_forward, tanh_gaussian_logp)

    g = torch.Generator(device=dev).manual_seed(seed)
    obs = torch.rand((O, M), generator=g, device=dev) * 2 - 1
    with torch.no_grad():
        mu, log_std, _ = actor_critic_forward(model, obs)
        pre = mu + log_std.exp() * torch.randn((A, M), generator=g,
                                               device=dev)
        old = tanh_gaussian_logp(pre, mu, log_std) + 0.3 * torch.randn(
            (M,), generator=g, device=dev)
    adv = torch.randn((M,), generator=g, device=dev)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ret = torch.randn((M,), generator=g, device=dev)
    return obs, pre, old, adv, ret


def _back_to_back(fn, n, sleep):
    """(the card's ms a call, the host's ms to enqueue one) over ``n`` calls
    enqueued without a sync, behind a sleep kernel if ``sleep``."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if sleep:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--env", default="supplychain-ntom-v0")
    ap.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    hidden = tuple(args.hidden)
    tree = Path(args.tree).resolve()
    if not (tree / "gym_supplychain_tpu_torch").is_dir():
        print(f"no gym_supplychain_tpu_torch in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    import torch
    import gym_supplychain_tpu_torch as sct

    cc = sct.make_chain(args.env, total_time_steps=args.horizon)
    O, A, M = cc.obs_dim, cc.A, args.horizon * args.envs
    bound = _bound(O, A, hidden, M)
    print(json.dumps(dict(env=args.env, O=O, A=A, hidden=hidden, M=M,
                          bound=bound)))
    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to time", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig
    from gym_supplychain_tpu_torch.ops import ppo_update as pu

    if not Path(sct.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {sct.__file__}, not from {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    model = ActorCritic(MLPConfig(O, A, hidden),
                        torch.Generator().manual_seed(args.seed), device=dev)
    with torch.no_grad():
        model.mu.w.mul_(100.0)
    data = _inputs(model, O, A, M, args.seed, dev)
    fns = {"float32": pu.make_ppo_update_grads(O, A, hidden, M),
           "bf16": pu.make_ppo_update_grads(O, A, hidden, M,
                                            compute_dtype=torch.bfloat16)}
    for gf in fns.values():               # the build and first-call set-up
        gf(model, *data)
    torch.cuda.synchronize()
    out = {}
    for sleep in (True, False):
        runs = {name: [] for name in fns}
        for _ in range(args.turns):
            for name in ("float32", "bf16", "bf16", "float32"):
                gf = fns[name]
                runs[name].append(_back_to_back(lambda: gf(model, *data),
                                                args.calls, sleep))
        for name, r in runs.items():
            out[f"{name} {'sleep' if sleep else 'plain'}"] = dict(
                card_ms=[round(c, 4) for c, _ in r],
                card_ms_median=round(statistics.median(c for c, _ in r), 4),
                host_ms_median=round(statistics.median(h for _, h in r), 4))
    print(json.dumps(dict(label=args.label, tree=str(tree), env=args.env,
                          O=O, A=A, hidden=hidden, M=M, calls=args.calls,
                          bound=bound, times=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
