"""Large-topology benchmark: the eager engine and the dense collect kernel.

The counterpart of ``benchmarks/large_topologies.py``, on three
configurations of 8-40 nodes, all with stochastic lead-times:
``sc-Nperstage-multiproduct-v0`` at ``[5, 4, 7, 10]`` nodes per echelon and
4 products, at 10 per echelon and 2 products, and
``sc-2perstage-multiproduct-v0`` at 10 products.  For each, at ``--envs``
environments:

* ``eager``: ms per step of the batched env (``make_vec_env``, uniform
  actions drawn on the device each step), from the slope between
  ``--eager-steps`` and twice as many steps; PyTorch runs eagerly, so there
  is no compile time to report;
* ``dense``: the dense collect kernel (K5, ``make_supplychain_dense_collect``
  in ``random`` mode: Philox inputs, auto-reset, obs every step) for 1 and
  2 episodes of ``--horizon`` steps a call; ms per step from the slope,
  env-steps/s, and the ms of one episode, with the plain version's ms for
  the same call (``--plain-reps`` timed calls, no warm-up) beside it;
* ``parity``: ``actions`` mode against the plain version on the same random
  tables (demands in the chain's range, lead-times, actions with a quarter
  at -1), at the full batch and horizon over ``--parity-episodes`` episodes:
  the largest obs error, the largest reward error over max|r|, and the
  lanes whose final stock differs (``--parity-episodes 0`` leaves it out).
  The kernel builds none of the JAX kernel's pre-gathered tables, so
  nothing forces a shorter horizon here.

On a CUDA device times come from CUDA events (median of ``--reps`` after a
warm-up); ``--device cpu`` runs the plain version everywhere, timed on the
host clock.  Prints one JSON object.

    python -m gym_supplychain_tpu_torch.benchmarks.large_topologies \
        --device cuda [--envs 4096] [--horizon 360] [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .. import make_chain
from ..envs.vector import make_vec_env
from ..ops import supplychain_dense as scd
from ..utils.profiling import counters

CONFIGS = {
    "nperstage-5-4-7-10-x4": ("sc-Nperstage-multiproduct-v0",
                              dict(nodes_per_echelon=[5, 4, 7, 10],
                                   num_products=4)),
    "nperstage-10-x2": ("sc-Nperstage-multiproduct-v0",
                        dict(nodes_per_echelon=10, num_products=2)),
    "multiproduct-x10": ("sc-2perstage-multiproduct-v0",
                         dict(num_products=10)),
}


def config_chain(name: str, T: int = 360):
    """The compiled chain of benchmark configuration ``name``."""
    env_id, kw = CONFIGS[name]
    return make_chain(env_id, stochastic_leadtimes=True, total_time_steps=T,
                      **kw)


def _timed(fn, reps: int, device, warmup: bool = True):
    """(median ms of ``fn()`` over ``reps`` calls, after a warm-up call
    where ``warmup``, last result): CUDA events on a card, the host clock
    on the CPU."""
    out = fn() if warmup else None
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def eager_step_ms(cc, B: int, steps: int, reps: int, device) -> float:
    """ms per step of the batched eager env, from the slope between
    ``steps`` and ``2 * steps`` steps."""
    init_fn, step_fn, _ = make_vec_env(cc, B, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def rollout(n):
        def run():
            st = init_fn(0)
            for _ in range(n):
                a = torch.rand((cc.A, B), generator=gen, device=device)
                st, out = step_fn(st, 2.0 * a - 1.0)
            return out.reward
        return run

    ms1, _ = _timed(rollout(steps), reps, device)
    ms2, _ = _timed(rollout(2 * steps), reps, device)
    return (ms2 - ms1) / steps


def parity_tables(cc, S: int, B: int, seed: int, device):
    """Random ``actions``-mode tables on ``device``: demands uniform in the
    chain's range, lead-times in 1..Lmax, actions uniform in [-1, 1) with
    those below -0.5 set to -1 (supplies that do not fire)."""
    g = torch.Generator(device=device).manual_seed(seed)
    act = 2.0 * torch.rand((S, cc.A, B), generator=g, device=device) - 1.0
    act = torch.where(act < -0.5, torch.full_like(act, -1.0), act)
    cols = []
    for p in range(cc.P):
        cfg = cc.demand[p if cc.demand_by_product else 0]
        cols.append(torch.randint(cfg.minv, cfg.maxv + 1, (S, cc.R, 1, B),
                                  generator=g, device=device))
    dem = torch.cat(cols, dim=2).to(torch.float32)
    lt = (torch.randint(1, cc.Lmax + 1, (S, cc.K, B), generator=g,
                        device=device, dtype=torch.int32)
          if cc.stochastic_leadtimes else None)
    return dem, lt, act


def parity(cc, B: int, episodes: int, seed: int, device) -> dict:
    """``actions`` mode of the kernel (the plain version on the CPU)
    against the plain version on the same tables."""
    S = episodes * cc.T
    dem, lt, act = parity_tables(cc, S, B, seed, device)
    kw = dict(demands=dem, leadtimes=lt, actions=act)
    if device.type == "cuda":
        desc = torch.as_tensor(scd.dense_descriptor(cc), device=device)
        k = scd.launch_supplychain_dense(desc, cc, S, B, "actions", **kw)
    else:
        k = scd.supplychain_dense_collect_plain(cc, episodes, B, "actions",
                                                **kw)
    p = scd.supplychain_dense_collect_plain(cc, episodes, B, "actions", **kw)
    obs_err = float((k[0] - p[0]).abs().max())
    rew_err = float((k[1] - p[1]).abs().max())
    scale = float(p[1].abs().max())
    rel = rew_err / scale if scale else 0.0
    lanes = int((k[2] != p[2]).any(dim=0).any(dim=0).sum())
    finite = bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all())
    return {"mode": "actions", "T": cc.T, "B": B, "episodes": episodes,
            "max_abs_obs_err": obs_err, "max_abs_reward_err": rew_err,
            "max_rel_reward_err": rel, "lanes_stock_differs": lanes,
            "finite": finite,
            "ok": bool(obs_err <= 1e-6 and rel <= 1e-5 and lanes == 0
                       and finite)}


def dense_timing(cc, B: int, reps: int, plain_reps: int, seed: int,
                 device) -> dict:
    """K5 ``random`` mode for 1 and 2 episodes a call; the plain version
    for one episode."""
    ms, launches = {}, 0
    for eps in (1, 2):
        run = scd.make_supplychain_dense_collect(cc, cc.T, B, mode="random",
                                                 episodes=eps, device=device)
        before = counters().get("launch.supplychain_dense", 0)
        ms[eps], (obs, rew) = _timed(lambda: run(seed), reps, device)
        launches += counters().get("launch.supplychain_dense", 0) - before
        if not (obs.shape == (eps * cc.T, cc.obs_dim, B)
                and bool(torch.isfinite(obs).all())
                and bool(torch.isfinite(rew).all())):
            raise RuntimeError("dense collect: output not finite or misshaped")
        del obs, rew
    # the plain version is host-bound and takes seconds: no warm-up
    plain_ms, _ = _timed(lambda: scd.supplychain_dense_collect_plain(
        cc, 1, B, "random", seed=seed, device=device), plain_reps, device,
        warmup=False)
    per_step = (ms[2] - ms[1]) / cc.T
    return {"ms_1_episode": ms[1], "ms_2_episodes": ms[2],
            "per_step_ms": per_step,
            "env_steps_per_s": B / (per_step * 1e-3) if per_step > 0
            else None,
            "launches": launches, "plain_ms_1_episode": plain_ms}


def run_benchmark(device="cuda", B: int = 4096, T: int = 360, reps: int = 5,
                  eager_steps: int = 10, parity_episodes: int = 2,
                  plain_reps: int = 1, seed: int = 0, configs=None) -> dict:
    """The benchmark's results for ``configs`` (default all) as a dict."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run the "
                               "plain version on the CPU")
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    out = {"device": kind, "B": B, "T": T,
           "protocol": f"median of {reps} after a warm-up; per-step times "
                       "from the slope between n and 2n steps (eager) or 1 "
                       "and 2 episodes a call (dense)"}
    for name in configs or CONFIGS:
        cc = config_chain(name, T)
        res = {"N": cc.N, "P": cc.P, "Dmax": cc.Dmax, "A": cc.A, "K": cc.K,
               "obs_dim": cc.obs_dim}
        if parity_episodes:
            res["parity"] = parity(cc, B, parity_episodes, seed, device)
        eager = eager_step_ms(cc, B, eager_steps, reps, device)
        res["eager"] = {"per_step_ms": eager,
                        "env_steps_per_s": B / (eager * 1e-3) if eager > 0
                        else None}
        res["dense"] = dense_timing(cc, B, reps, plain_reps, seed, device)
        out[name] = res
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=360)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--eager-steps", type=int, default=10)
    ap.add_argument("--parity-episodes", type=int, default=2)
    ap.add_argument("--plain-reps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--configs", nargs="+", choices=sorted(CONFIGS))
    args = ap.parse_args(argv)
    out = run_benchmark(args.device, args.envs, args.horizon, args.reps,
                        args.eager_steps, args.parity_episodes,
                        args.plain_reps, args.seed, args.configs)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    res = main()
    sys.exit(0 if all(v.get("parity", {"ok": True})["ok"]
                      for k, v in res.items() if k in CONFIGS) else 1)
