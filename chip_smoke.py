#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the collect kernels from ``gym_supplychain_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the main
path (trajectory collection at 4096 envs for ``supplychain-linear-v0``,
``supplychain-ntom-v0`` and ``beergame-v0``) through the package's entry
points, timing kernel and plain version with CUDA events.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits nonzero:
  1. device, power limit, torch/CUDA/nvcc versions; kernel build time
  2. supply-chain kernel, ``actions`` mode, against plain (linear, ntom)
  3. supply-chain kernel, ``random`` mode, against plain; marginals
  4. beer-game kernel: v0 random and actions, v2 per-lane actions
  5. the main path: env-steps/s of kernel and plain, launch counts
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it prints no result and
exits nonzero.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEEKS = 35
ENVS = 4096                # the batch the JAX package's benchmark uses
CHECK_EPISODES = 2         # phases 2-4: two episodes cover the auto-reset
MAIN_EPISODES = 8          # phase 5: episodes per main-path call
REPS = 5                   # phase 5: timed calls after a warm-up (median)
OBS_ATOL = 1e-6            # obs, kernel vs plain (the JAX collect tests')
REW_RTOL = 1e-5            # reward error / max|reward|


def _cmd(args):
    res = subprocess.run(args, capture_output=True, text=True, timeout=60)
    return (res.stdout or res.stderr).strip()


def _timed(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` calls after a warm-up,
    between CUDA events; returns (ms, last result)."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def _compare(k, p):
    """(max |obs err|, max |reward err| / max |reward|, lanes whose final
    stock differs) for kernel and plain (obs, reward, stock)."""
    import torch

    obs_err = float((k[0] - p[0]).abs().max())
    scale = float(p[1].abs().max())
    rew_err = float((k[1] - p[1]).abs().max())
    lanes = int((k[2] != p[2]).any(dim=0).any(dim=0).sum()) if len(k) > 2 else 0
    finite = bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all())
    return obs_err, rew_err, (rew_err / scale if scale else 0.0), lanes, finite


def _check_sc(tag, k, p, errs):
    obs_err, rew_abs, rew_rel, lanes, finite = _compare(k, p)
    print(f"  {tag}: max obs err {obs_err:.3e} (tol {OBS_ATOL:g}), max reward "
          f"err / max|r| {rew_rel:.3e} (tol {REW_RTOL:g}), lanes with "
          f"divergent stock {lanes}, finite {finite}")
    errs.append(max(obs_err, rew_abs))
    if not (obs_err <= OBS_ATOL and rew_rel <= REW_RTOL and lanes == 0
            and finite):
        raise RuntimeError(f"{tag}: kernel disagrees with its plain version")


def _sc_tables(cc, S, B, seed, device):
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    act = (2 * rs.rand(S, cc.A, B) - 1).astype(np.float32)
    act[act < -0.5] = -1.0              # some supplies must not fire
    dem = rs.randint(0, 25, size=(S, cc.R, cc.P, B)).astype(np.float32)
    lt = (rs.randint(1, cc.Lmax + 1, size=(S, cc.K, B)).astype(np.int32)
          if cc.stochastic_leadtimes else None)
    put = (lambda x: None if x is None
           else torch.as_tensor(x, device=device).contiguous())
    return put(dem), put(lt), put(act)


def phase_supplychain(chains, B, episodes, seed, errs):
    """Phases 2 and 3: the supply-chain kernel against its plain version."""
    import numpy as np
    import torch
    from gym_supplychain_tpu_torch.ops.supplychain_collect import (
        chain_descriptor, launch_supplychain_collect, philox_tables,
        supplychain_collect_plain)
    from gym_supplychain_tpu_torch.rng.device import poisson_clip_thresholds

    dev = torch.device("cuda")
    print("phase 2: supplychain_collect, mode 'actions', vs plain")
    for env_id, cc in chains.items():
        S = episodes * cc.T
        desc = torch.as_tensor(chain_descriptor(cc), device=dev)
        dem, lt, act = _sc_tables(cc, S, B, seed, dev)
        k = launch_supplychain_collect(desc, cc, S, B, "actions", demands=dem,
                                       leadtimes=lt, actions=act)
        p = supplychain_collect_plain(cc, episodes, B, "actions", demands=dem,
                                      leadtimes=lt, actions=act)
        torch.cuda.synchronize()
        _check_sc(f"{env_id} B={B} T={cc.T} episodes={episodes}", k, p, errs)

    print("phase 3: supplychain_collect, mode 'random', vs plain")
    for env_id, cc in chains.items():
        S = episodes * cc.T
        desc = torch.as_tensor(chain_descriptor(cc), device=dev)
        k = launch_supplychain_collect(desc, cc, S, B, "random", seed=seed)
        p = supplychain_collect_plain(cc, episodes, B, "random", seed=seed,
                                      device=dev)
        torch.cuda.synchronize()
        _check_sc(f"{env_id} B={B} T={cc.T} episodes={episodes}", k, p, errs)
        # marginals of the drawn rows against their distributions
        dem, lt, _ = philox_tables(cc, seed, range(S), B, dev)
        cfg = cc.demand[0]
        want = (cfg.minv + cfg.maxv) / 2
        got = float(dem.double().mean())
        sd = (cfg.maxv - cfg.minv + 1) / math.sqrt(12 * dem.numel())
        print(f"  {env_id}: mean demand {got:.4f} (expected {want}, "
              f"5 sd = {5 * sd:.4f})")
        if abs(got - want) > 5 * sd + 1e-3:
            raise RuntimeError(f"{env_id}: demand marginal off")
        if lt is not None:
            cdf = poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax).astype(np.float64)
            pmf = np.diff(np.concatenate([[0.0], cdf, [1.0]]))
            hist = torch.bincount(lt.flatten().long(),
                                  minlength=cc.Lmax + 1)[1:].double()
            hist = (hist / hist.sum()).cpu().numpy()
            print(f"  {env_id}: lead-time histogram {np.round(hist, 5).tolist()}"
                  f" vs pmf {np.round(pmf, 5).tolist()}")
            if np.abs(hist - pmf).max() > 6 * 0.5 / math.sqrt(lt.numel()):
                raise RuntimeError(f"{env_id}: lead-time marginal off")


def phase_beergame(B, episodes, seed, errs):
    """Phase 4: the beer-game kernel, bit-exact against its plain version."""
    import numpy as np
    import torch
    from gym_supplychain_tpu_torch.ops.beergame_collect import (
        beergame_collect_plain, launch_beergame_collect)

    dev = torch.device("cuda")
    L, W = 4, WEEKS
    S = episodes * W
    rs = np.random.RandomState(seed)
    put = lambda x: torch.as_tensor(x, device=dev).contiguous()   # noqa: E731
    v0_dem = put(np.tile(np.array([4] * 4 + [8] * (W - 4), np.int32)[:, None],
                         (episodes, B)))
    cases = [
        ("v0 random", dict(mode="random", demand=v0_dem, seed=seed)),
        ("v0 actions", dict(mode="actions", demand=v0_dem,
                            actions=put(rs.randint(0, 16, size=(S, L, B))
                                        .astype(np.int32)))),
        ("v2 per-lane actions", dict(
            mode="actions",
            demand=put(rs.randint(0, 12, size=(S, B)).astype(np.int32)),
            delays=put(rs.randint(0, 5, size=(S, B)).astype(np.int32)),
            actions=put(rs.randint(0, 20, size=(S, L, B)).astype(np.int32)),
            delay=None, max_delay=4, v2=True, max_stock=40,
            exceeded_capacity_penalty=37)),
    ]
    print("phase 4: beergame_collect vs plain (bit-exact)")
    for tag, kw in cases:
        k = launch_beergame_collect(W, L, B, episodes, **kw)
        p = beergame_collect_plain(W, L, B, episodes, **kw)
        torch.cuda.synchronize()
        obs_err = int((k[0] - p[0]).abs().max())
        rew_err = int((k[1] - p[1]).abs().max())
        print(f"  {tag} B={B} weeks={W} episodes={episodes}: max obs err "
              f"{obs_err}, max reward err {rew_err}")
        errs.append(float(max(obs_err, rew_err)))
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise RuntimeError(f"beergame {tag}: kernel is not bit-exact")


def phase_main_path(B, episodes, seed, reps):
    """Phase 5: the main path through the package's entry points."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.ops import beergame_collect as bgc
    from gym_supplychain_tpu_torch.ops import supplychain_collect as scc

    dev = torch.device("cuda")
    runs = {}
    for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0"):
        cc = sct.make_chain(env_id)
        runs[env_id] = (scc.launch_supplychain_collect,
                        scc.make_supplychain_collect(
                            cc, cc.T, B, mode="random", episodes=episodes,
                            device="cuda"),
                        episodes * cc.T,
                        lambda cc=cc: scc.supplychain_collect_plain(
                            cc, episodes, B, "random", seed=seed, device=dev))
    spec = sct.make_chain("beergame-v0")
    bg_kw = dict(delay=spec.delay, init_ship=spec.init_ship,
                 init_orders=spec.init_orders, init_inv=spec.init_inv,
                 inv_cost=spec.inv_cost, backlog_cost=spec.backlog_cost)
    bg_run = bgc.make_beergame_collect(spec.weeks, spec.levels, B,
                                       episodes=episodes, mode="random",
                                       device="cuda", **bg_kw)
    S_bg = episodes * spec.weeks
    bg_dem = torch.as_tensor(spec.demand, dtype=torch.int32, device=dev)
    runs["beergame-v0"] = (
        bgc.launch_beergame_collect,
        lambda seed: bg_run(spec.demand, seed), S_bg,
        lambda: bgc.beergame_collect_plain(
            spec.weeks, spec.levels, B, episodes, "random",
            demand=bg_dem[:, None].expand(spec.weeks, B).repeat(episodes, 1),
            seed=seed, **bg_kw))

    # launch counts: zero, drive the main path, read
    scc.launch_supplychain_collect.launches = 0
    bgc.launch_beergame_collect.launches = 0
    results = {}
    for env_id, (launcher, run, S, _) in runs.items():
        before = launcher.launches
        ms, out = _timed(lambda: run(seed), reps)
        results[env_id] = dict(ms=ms, launches=launcher.launches - before,
                               out=out, S=S)
    counts = {"supplychain_collect": scc.launch_supplychain_collect.launches,
              "beergame_collect": bgc.launch_beergame_collect.launches}

    print(f"phase 5: main path, mode 'random', B={B}, episodes={episodes}, "
          f"median of {reps} after a warm-up (CUDA events)")
    for env_id, (_, _, S, plain) in runs.items():
        r = results[env_id]
        plain_ms, p = _timed(plain, reps)
        r["plain_ms"] = plain_ms
        k = r.pop("out")
        # the main path's output against the plain run on the same seed
        if env_id.startswith("beergame"):
            ok = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
            err = float(max((k[0] - p[0]).abs().max(), (k[1] - p[1]).abs().max()))
        else:
            obs_err, rew_abs, rew_rel, _, finite = _compare(k, p)
            ok = obs_err <= OBS_ATOL and rew_rel <= REW_RTOL and finite
            ok = ok and bool((k[0].abs() <= 1).all())
            err = max(obs_err, rew_abs)
        r["max_abs_err"] = err
        shape_ok = k[0].shape[0] == S and k[0].shape[-1] == B
        steps = S * B
        print(f"  {env_id}: kernel {r['ms']:.3f} ms = "
              f"{steps / r['ms'] * 1e3:.4e} env-steps/s; plain "
              f"{plain_ms:.3f} ms = {steps / plain_ms * 1e3:.4e} env-steps/s;"
              f" launches {r['launches']}; output shape {tuple(k[0].shape)}; "
              f"agrees with plain {ok}")
        if not (ok and shape_ok and r["launches"] > 0):
            raise RuntimeError(f"main path {env_id} failed")
    print(f"  launch counts after the main path: {counts}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "gym_supplychain_tpu_torch").is_dir():
        print("gym_supplychain_tpu_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.ops import _build

    # phase 1
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: device {kind}, {torch.cuda.device_count()} visible")
    print(_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {_cmd([_build.nvcc_path(), '--version']).splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")

    B = ENVS
    chains = {env_id: sct.make_chain(env_id)
              for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0")}
    sc_errs, bg_errs = [], []
    phase_supplychain(chains, B, CHECK_EPISODES, args.seed, sc_errs)
    phase_beergame(B, CHECK_EPISODES, args.seed, bg_errs)
    res = phase_main_path(B, MAIN_EPISODES, args.seed, REPS)

    src = "gym_supplychain_tpu_torch/csrc/"
    kernels = []
    for env_id, r in res.items():
        bg = env_id.startswith("beergame")
        errs = bg_errs if bg else sc_errs
        kernels.append(dict(
            name=("beergame_collect" if bg else "supplychain_collect")
            + f"[{env_id}]",
            route="cuda",
            source=src + ("beergame_collect.cu" if bg
                          else "supplychain_collect.cu"),
            replaces=("gym_supplychain_tpu/ops/beergame_pallas.py:149" if bg
                      else "gym_supplychain_tpu/ops/supplychain_pallas.py:791"),
            launches=r["launches"],
            max_abs_err=max(errs + [r["max_abs_err"]]),
            ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
