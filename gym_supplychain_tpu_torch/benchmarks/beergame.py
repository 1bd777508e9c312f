"""The beer-game kernels on the card: K3 (collection) and K6b (the episode
sweep), each timed alone and through its entry point.

Cases, each checked bit for bit against its plain version before timing:

* ``k3_v0``: ``beergame-v0`` at ``--envs`` envs, 8 episodes a call,
  ``random``, the collection metric's config (``chip_smoke.py`` phase 5);
* ``k3_v2_<B>``: the v2 stochastic config of the JAX package's
  ``bench.py`` (4 levels, per-lane demand in [0, 12) and delays in [0, 4)
  drawn per week, ``max_delay`` 3, ``max_stock`` 100, penalty 100,
  ``random`` with ``max_order`` 16), 8 episodes a call, at ``--envs`` and
  at 1024 envs (``BASELINE.json``'s ``beergame-v2`` batch);
* ``k6b``: one 35-week v0 episode at ``--envs`` envs with per-lane demand,
  orders and initial inventory (``chip_smoke.py`` phase 12).

For each: ``kernel_ms``, the card's time a launch, back to back behind a
sleep kernel so that the host's enqueue stays out of the window (CUDA
events over ``BACK_TO_BACK`` launches); ``launch_ms``, one call of the
launcher (``launch_beergame_collect`` / ``launch_beergame_episode``) on
prebuilt tensors between CUDA events, median of ``--reps``; ``entry_ms``,
one call of the entry point (``make_beergame_collect``'s ``run`` with the
numpy demand of the preset, as phase 5 calls it, or ``beergame_episode``)
the same way; ``launch_host_us`` and ``entry_host_us``, the host's time a
call of each, 50 calls enqueued without a sync.  Where the package has the launch planner
(``beergame_block``), ``--sweep 8,16,32,64`` also times ``kernel_ms`` of
every case at each number of envs a block.  The ptxas report of every
``bg_collect_kernel`` instance comes with it.  Needs a CUDA device; prints
one JSON object with the card's name and power limit.

    python -m gym_supplychain_tpu_torch.benchmarks.beergame [--reps 9]
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from .. import make_chain
from ..ops import _build
from ..ops import beergame_collect as bgc
from ..ops import beergame_episode as bge
from .large_topologies import _timed

BACK_TO_BACK = 20
EPISODES = 8
V2 = dict(delay=None, max_delay=3, v2=True, max_stock=100,
          exceeded_capacity_penalty=100, max_order=16)


def device_ms(fn, reps):
    """Median over ``reps`` windows of the card's ms a call of ``fn``:
    ``BACK_TO_BACK`` calls enqueued behind a sleep kernel long enough to
    cover their enqueue, so the window holds card time alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BACK_TO_BACK):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3 * host_s * 2e9) + 1_000_000)
        start.record()
        for _ in range(BACK_TO_BACK):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / BACK_TO_BACK)
    return statistics.median(times)


def host_us(fn, calls=50):
    """Host microseconds a call of ``fn``, ``calls`` calls enqueued
    without a sync (the card keeps up or queues them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def _cases(B, seed, dev):
    """name -> (launch, entry, plain), each a function of no argument."""
    spec = make_chain("beergame-v0")
    W, L = spec.weeks, spec.levels
    S = EPISODES * W
    v0 = dict(delay=spec.delay, init_ship=spec.init_ship,
              init_orders=spec.init_orders, init_inv=spec.init_inv,
              inv_cost=spec.inv_cost, backlog_cost=spec.backlog_cost)
    dem = torch.as_tensor(spec.demand, dtype=torch.int32, device=dev)
    dem = dem[:, None].expand(W, B).repeat(EPISODES, 1)
    run = bgc.make_beergame_collect(W, L, B, episodes=EPISODES,
                                    mode="random", device=dev, **v0)
    cases = {"k3_v0": (
        lambda: bgc.launch_beergame_collect(W, L, B, EPISODES, "random",
                                            demand=dem, seed=seed, **v0),
        lambda: run(spec.demand, seed),
        lambda: bgc.beergame_collect_plain(W, L, B, EPISODES, "random",
                                           demand=dem, seed=seed, **v0))}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for b in dict.fromkeys((B, 1024)):
        d = torch.randint(0, 12, (S, b), generator=gen, device=dev,
                          dtype=torch.int32)
        dl = torch.randint(0, 4, (S, b), generator=gen, device=dev,
                           dtype=torch.int32)
        run2 = bgc.make_beergame_collect(W, L, b, episodes=EPISODES,
                                         mode="random", device=dev, **V2)
        kw = dict(demand=d, delays=dl, seed=seed, **V2)
        cases[f"k3_v2_{b}"] = (
            functools.partial(bgc.launch_beergame_collect, W, L, b, EPISODES,
                              "random", **kw),
            functools.partial(run2, d, dl, seed),
            functools.partial(bgc.beergame_collect_plain, W, L, b, EPISODES,
                              "random", **kw))
    rs = np.random.RandomState(seed)
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    args = (put(rs.randint(0, 13, size=(W, B)).astype(np.int32)),
            put(rs.randint(0, 16, size=(W, L, B)).astype(np.int32)),
            put(rs.randint(0, 2 * spec.init_inv + 1, size=(L, B))
                .astype(np.int32)))
    ep = dict(delay=spec.delay, init_ship=spec.init_ship,
              init_orders=spec.init_orders, inv_cost=spec.inv_cost,
              backlog_cost=spec.backlog_cost)
    cases["k6b"] = (
        lambda: bge.launch_beergame_episode(*args, **ep),
        lambda: bge.beergame_episode(*args, device=dev, **ep),
        lambda: bge.beergame_episode_plain(*args, **ep))
    return cases


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_benchmark(B: int = 4096, reps: int = 9, seed: int = 0,
                  sweep=()) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the beer-game benchmark times the CUDA kernels: "
                           "no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
           "B": B, "episodes": EPISODES,
           "protocol": f"kernel_ms: {BACK_TO_BACK} launches back to back "
                       f"behind a sleep; launch_ms, entry_ms: one call; "
                       f"median of {reps} (CUDA events)",
           "ptxas": _build.ptxas_report("bg_collect_kernel"), "cases": {}}
    planner = getattr(bgc, "beergame_block", None)
    for name, (launch, entry, plain) in _cases(B, seed, dev).items():
        k, e, p = launch(), entry(), plain()
        torch.cuda.synchronize()
        if not (_same(k, p) and _same(e, p)):
            raise RuntimeError(f"{name}: kernel and plain version differ")
        res = {"bit_exact": True,
               "kernel_ms": device_ms(launch, reps),
               "launch_ms": _timed(launch, reps, dev)[0],
               "entry_ms": _timed(entry, reps, dev)[0],
               "launch_host_us": host_us(launch),
               "entry_host_us": host_us(entry)}
        b = (k[0] if isinstance(k, tuple) else k).shape[-1]
        if planner is not None:
            res["plan"] = planner(4, b)
            res["sweep"] = {}
            for envs in sweep:
                with mock.patch.object(bgc, "beergame_block",
                                       functools.partial(planner, envs=envs)):
                    if not _same(launch(), p):
                        raise RuntimeError(f"{name}: {envs} envs a block "
                                           "differs from plain")
                    res["sweep"][envs] = device_ms(launch, reps)
        out["cases"][name] = res
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", default="",
                    help="envs a block to time, comma separated")
    args = ap.parse_args(argv)
    sweep = [int(x) for x in args.sweep.split(",") if x]
    out = run_benchmark(args.envs, args.reps, args.seed, sweep)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
