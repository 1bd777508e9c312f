#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the kernels from ``gym_supplychain_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the main paths
through the package's entry points, timing kernel and plain version with
CUDA events: trajectory collection at 4096 envs for
``supplychain-linear-v0``, ``supplychain-ntom-v0`` and ``beergame-v0``, the
PPO trainer on ``supplychain-ntom-v0`` at 4096 envs, hidden (128, 128),
horizon 60, greedy evaluation of its checkpoint at 4096 envs, horizon 360,
with the base-stock baseline beside it, the large-topology benchmark's
three chains (26, 40 and 8 nodes) at 4096 envs, horizon 360, the
beer-game episode sweep at 4096 envs, and collection, training and
evaluation on normal and seasonal demand drawn in the kernels.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits nonzero:
  1. device, power limit, torch/CUDA/nvcc versions; kernel build time;
     ptxas's registers and spills of the update kernel, of every instance
     of the lane-group kernel (K1 ``random``/``actions``, K6a, K5), of
     the policy lane kernel (K1's policy modes, K4) and of the beer-game
     kernel (K3, K6b)
  2. supply-chain kernel, ``actions`` mode, against plain (linear, ntom)
  3. supply-chain kernel, ``random`` mode, against plain; marginals
  4. beer-game kernel, bit-exact against plain: v0 random and actions, v2
     per-lane actions, 3 and 6 levels (idle lanes in a group), delay 0, a
     ragged B + 7, the v2 stochastic config at max_delay 3 and 4
  5. the collection path: env-steps/s of kernel and plain, launch counts,
     the lane-group kernel's lanes an env, envs a block and grid, the
     geomean; then K3 alone on the card beside its entry point, and the v2
     stochastic config (outside the geomean) at B and 1024 envs, alone and
     through ``make_beergame_collect``
  6. supply-chain kernel, policy modes, against plain (linear, ntom, at
     B and at a ragged B + 7): ``policy_eps`` on Philox tables, ``policy``
     against ``policy_eps``, the ``sample_major`` layout against the
     default one; the policy lane kernel's lanes, envs a block and grid
  7. the PPO update kernel against plain, both against float64 autograd,
     at M = 60 * 4096 samples; two launches must give the same bits; its
     time a call alone and back to back (card and host apart)
  8. the trainer's path: the train CLI, then ``make_ppo_fused`` timed per
     phase (collect / gae / update) against the plain trainer, whose first
     iteration must match the kernel trainer's; then K1 ``policy`` alone at
     the trainer's shape beside its plain version
  9. the episode kernel against plain at B = 4096, T = 360 (linear, ntom):
     ``actions`` on random tables, ``seeded`` against ``actions`` fed its
     Philox rows (bit for bit), greedy ``policy`` at hidden (128, 128);
     then the rewards-only sweeps through ``make_supplychain_episode``,
     with the lane-group kernel's lanes, envs a block and grid
  10. the evaluation path: the train CLI writes a checkpoint, a resumed run
     must repeat the uninterrupted one bit for bit, the evaluate CLI runs
     both engines on it (B = 4096, T = 360, 4 episodes; they share their
     inputs, so their mean returns agree within 1e-5), ``best_base_stock``
     runs at the same size; both evaluators are timed, and the kernel
     evaluator's table draw alone
  11. the dense collect kernel (K5) at B = 4096, T = 360 on the configs of
     ``gym_supplychain_tpu_torch.benchmarks.large_topologies``: ``actions``
     on random tables against plain over 2 episodes (all three), ``random``
     against plain on its Philox tables ([5,4,7,10] x 4), then the
     benchmark's timings (1 and 2 episodes a call, the plain version, the
     eager env's step)
  12. the beer-game episode sweep (K6b), beergame-v0 at B = 4096: bit-exact
     against plain at delay 2 and at delay 0 with init_delay 2, at B and at
     a ragged B + 7, then timed through ``beergame_episode`` and alone
  13. demand processes drawn in the kernels: K1 ``random`` at B = 4096,
     T = 360, one episode, on ``sc-2perstage-seasonal-v0``,
     ``sc-2perstage-multiproduct-v1`` (defaults, and std 10 with a normal
     perturbation), ``sc-2perstage-multiproduct-inccosts-v1`` (std 10) and
     the seasonal chain at B + 7: equal to ``actions`` on its Philox
     tables bit for bit, obs and stock bit-equal to plain, rewards within
     1e-5 * max|r|; K1 ``policy`` on the seasonal chain at phase 6's shape
     and gates; K5 ``random`` on phase 11's [5,4,7,10] x 4 with seasonal
     demand at its gates; then K1 ``random`` timed (8 episodes) on the
     seasonal chain beside ``sc-2perstage-v0`` (uniform demand, the same
     graph) and on the normal multiproduct-v1, K5 seasonal beside uniform;
     the train CLI on the seasonal chain at phase 8's shape (K1 ``policy``
     and K2 launched) and the trainer's phases, the evaluate CLI with both
     engines on its checkpoint (one episode, mean returns within 1e-5)
The line before the last is a JSON summary of the kernels, each with its
bound: the larger of the bytes it must move over 3.35 TB/s and the float32
operations it must do over 67 TFLOP/s (the H100 SXM data sheet at 700 W;
the env step's scalar operations are not counted, so the bound stays a
lower bound); beside K1 ``policy`` and K4 the text prints the bound without
FMA contraction, which their float rules forbid (twice the MLP's).  The
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the package beside it, it prints the reason and no result and exits 2.
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
BACK_TO_BACK = 20          # phase 7: update calls enqueued without a sync
OBS_ATOL = 1e-6            # obs, kernel vs plain (the JAX collect tests')
REW_RTOL = 1e-5            # reward error / max|reward|
TRAIN_T = 60               # phases 6-8: the trainer's horizon (one episode)
HIDDEN = (128, 128)        # phases 6-8: the trainer's widths
PRE_ATOL, VALUE_ATOL = 1e-4, 1e-4   # policy outputs (the JAX collect tests')
LOGP_RTOL, LOGP_ATOL = 1e-4, 1e-3
TRAIN_REPS, PLAIN_TRAIN_REPS = 5, 3  # phase 8: timed iterations (median)
EVAL_EPISODES = 4          # phase 10: the evaluate CLI's episodes
PLAIN_REPS = 2             # phases 9-10: timed plain calls (median)
EVAL_RTOL = 1e-5           # phase 10: kernel vs scan evaluator, mean return
RAGGED = 7                 # phases 4, 6, 12: B + 7 envs, a ragged last block
DENSE_REPS = 3             # phase 11: timed calls of the dense kernel (median)
EAGER_STEPS = 10           # phase 11: the eager env's slope, 10 vs 20 steps
PEAK_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s


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


def _bound(n_bytes, n_flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``n_bytes`` and do ``n_flops`` float32 operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _collect_bound(cc, S, B):
    """The bound of a collection of S steps of B envs: obs [S,O,B], reward
    [S,B] and the final stock out, float32."""
    return _bound(4 * B * (S * (cc.obs_dim + 1) + cc.N * cc.P), 0)


def _macs(layout, nets):
    """Multiply-adds of one forward pass of the networks ``nets`` (0 the
    actor with its mu head, 1 the critic with its v head)."""
    return sum(K * J for net in nets for K, J, *_ in layout.layers[net])


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


def _plan(cc, kind, B):
    """The lane-group kernel's plan for ``kind`` as printed beside a time:
    lanes an env, envs a block and the grid (blocks x threads)."""
    from gym_supplychain_tpu_torch.ops.supplychain_dense import lane_block

    G, E, _, smem = lane_block(cc, kind)
    return (f"G={G} lanes an env, E={E} envs a block, grid "
            f"{-(-B // E)} x {G * E} threads, {smem} B shared a block")


def _policy_plan(cc, layout, B, nets):
    """The policy lane kernel's plan as printed beside a time."""
    from gym_supplychain_tpu_torch.ops.supplychain_dense import policy_block

    G, E, _, smem = policy_block(cc, layout, B, nets)
    return (f"G={G} lanes an env, E={E} envs a block, grid "
            f"{-(-B // E)} x {G * E} threads, {smem} B shared a block")


def _issue_bound_ms(macs):
    """The least time of ``macs`` multiply-adds without FMA contraction: an
    FMUL and an FADD each, at one float32 instruction a lane a clock (half
    the FLOP peak, which counts an FMA as two operations)."""
    return 1e3 * 2 * macs / (PEAK_FLOPS / 2)


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
        launch_supplychain_collect, philox_tables, supplychain_collect_plain)
    from gym_supplychain_tpu_torch.ops.supplychain_dense import (
        dense_descriptor)
    from gym_supplychain_tpu_torch.rng.device import poisson_clip_thresholds

    dev = torch.device("cuda")
    print("phase 2: supplychain_collect, mode 'actions', vs plain")
    for env_id, cc in chains.items():
        S = episodes * cc.T
        desc = torch.as_tensor(dense_descriptor(cc), device=dev)
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
        desc = torch.as_tensor(dense_descriptor(cc), device=dev)
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
    """Phase 4: the beer-game kernel, bit-exact against its plain version:
    v0 and v2, idle lanes in a group (3, 6 levels), delay 0, a ragged last
    block, the v2 stochastic config at max_delay 3 and 4."""
    import numpy as np
    import torch
    from gym_supplychain_tpu_torch.ops.beergame_collect import (
        beergame_block, beergame_collect_plain, launch_beergame_collect)

    dev = torch.device("cuda")
    W = WEEKS
    S = episodes * W
    rs = np.random.RandomState(seed)
    put = lambda x: torch.as_tensor(x, device=dev).contiguous()   # noqa: E731
    rand = lambda hi, *shape: put(rs.randint(0, hi, size=shape)   # noqa: E731
                                  .astype(np.int32))
    v0_dem = lambda b: put(np.tile(                               # noqa: E731
        np.array([4] * 4 + [8] * (W - 4), np.int32)[:, None], (episodes, b)))

    def stochastic(b, maxd):
        return dict(mode="random", seed=seed, demand=rand(12, S, b),
                    delays=rand(maxd + 1, S, b), delay=None, max_delay=maxd,
                    v2=True, max_stock=100, exceeded_capacity_penalty=100)

    cases = [
        ("v0 random", 4, B, dict(mode="random", demand=v0_dem(B), seed=seed)),
        ("v0 actions", 4, B, dict(mode="actions", demand=v0_dem(B),
                                  actions=rand(16, S, 4, B))),
        ("v2 per-lane actions", 4, B, dict(
            mode="actions", demand=rand(12, S, B), delays=rand(5, S, B),
            actions=rand(20, S, 4, B), delay=None, max_delay=4, v2=True,
            max_stock=40, exceeded_capacity_penalty=37)),
        ("L=3 random", 3, B, dict(mode="random", demand=v0_dem(B),
                                  seed=seed)),
        ("L=6 actions", 6, B, dict(mode="actions", demand=rand(12, S, B),
                                   actions=rand(16, S, 6, B))),
        ("delay 0, init_delay 2", 4, B, dict(
            mode="actions", demand=rand(12, S, B), actions=rand(16, S, 4, B),
            delay=0, init_delay=2)),
        (f"ragged B+{RAGGED} random", 4, B + RAGGED, dict(
            mode="random", demand=v0_dem(B + RAGGED), seed=seed)),
        ("v2 stochastic max_delay 3", 4, B, stochastic(B, 3)),
        ("v2 stochastic max_delay 4", 4, B, stochastic(B, 4)),
    ]
    print("phase 4: beergame_collect vs plain (bit-exact)")
    for tag, L, b, kw in cases:
        k = launch_beergame_collect(W, L, b, episodes, **kw)
        p = beergame_collect_plain(W, L, b, episodes, **kw)
        torch.cuda.synchronize()
        obs_err = int((k[0] - p[0]).abs().max())
        rew_err = int((k[1] - p[1]).abs().max())
        G, E, grid = beergame_block(L, b)
        print(f"  {tag} L={L} B={b} weeks={W} episodes={episodes}: max obs "
              f"err {obs_err}, max reward err {rew_err}; {G} lanes an env, "
              f"{E} envs a block, {grid} blocks")
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
    runs, plans = {}, {}
    for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0"):
        cc = sct.make_chain(env_id)
        plans[env_id] = "; " + _plan(cc, "collect", B)
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
              f"agrees with plain {ok}{plans.get(env_id, '')}")
        if not (ok and shape_ok and r["launches"] > 0):
            raise RuntimeError(f"main path {env_id} failed")
    print(f"  launch counts after the main path: {counts}")
    rates = [results[e]["S"] * B / results[e]["ms"] * 1e3 for e in runs]
    print(f"  geomean {math.prod(rates) ** (1 / len(rates)):.4e} "
          f"env-steps/s")
    _beergame_alone(spec, bg_kw, bg_dem, B, episodes, seed, results)
    return results


def _beergame_alone(spec, bg_kw, bg_dem, B, episodes, seed, results):
    """Phase 5, after the main path's counts: K3 alone on beergame-v0
    beside its entry point, then the v2 stochastic config (outside the
    geomean) at B and 1024 envs through ``make_beergame_collect`` and
    alone, bit-exact against plain.  Alone: the card's time a launch,
    back to back behind a sleep kernel, on prebuilt [S, B] tables."""
    import torch
    from gym_supplychain_tpu_torch.benchmarks.beergame import V2, device_ms
    from gym_supplychain_tpu_torch.ops import beergame_collect as bgc
    from gym_supplychain_tpu_torch.ops.beergame_collect import beergame_block

    W, L = spec.weeks, spec.levels
    S = episodes * W
    dem = bg_dem[:, None].expand(W, B).repeat(episodes, 1)
    r = results["beergame-v0"]
    r["alone_ms"] = device_ms(lambda: bgc.launch_beergame_collect(
        W, L, B, episodes, "random", demand=dem, seed=seed, **bg_kw), REPS)
    G, E, grid = beergame_block(L, B)
    print(f"  beergame-v0 K3 alone {r['alone_ms']:.4f} ms on the card a "
          f"launch, entry point {r['ms']:.4f} ms; {G} lanes an env, {E} envs"
          f" a block, {grid} blocks")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for b in (B, 1024):
        d = torch.randint(0, 12, (S, b), generator=gen, device="cuda",
                          dtype=torch.int32)
        dl = torch.randint(0, 4, (S, b), generator=gen, device="cuda",
                           dtype=torch.int32)
        run = bgc.make_beergame_collect(W, L, b, episodes=episodes,
                                        mode="random", device="cuda", **V2)
        ms, k = _timed(lambda: run(d, dl, seed), REPS)
        alone = device_ms(lambda: bgc.launch_beergame_collect(
            W, L, b, episodes, "random", demand=d, delays=dl, seed=seed,
            **V2), REPS)
        p = bgc.beergame_collect_plain(W, L, b, episodes, "random",
                                       demand=d, delays=dl, seed=seed, **V2)
        ok = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        G, E, grid = beergame_block(L, b)
        print(f"  beergame v2 stochastic B={b}: entry point {ms:.4f} ms = "
              f"{S * b / ms * 1e3:.4e} env-steps/s, K3 alone {alone:.4f} ms;"
              f" {G} lanes an env, {E} envs a block, {grid} blocks; "
              f"bit-exact {ok}")
        if not ok:
            raise RuntimeError(f"beergame v2 stochastic B={b}: not bit-exact")


def _policy_model(cc, seed, dev):
    import torch
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig

    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, HIDDEN),
                        torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        model.mu.w.mul_(100.0)        # non-degenerate actions
    return model


def _check_policy(tag, k, p, errs):
    """k, p: (obs, act_pre, logp, value, reward, final stock)."""
    import torch

    obs_err, pre_err, logp_err, value_err, rew_err = (
        float((a - b).abs().max()) for a, b in zip(k[:5], p[:5]))
    rew_rel = rew_err / max(float(p[4].abs().max()), 1e-30)
    logp_ok = bool(torch.allclose(k[2], p[2], rtol=LOGP_RTOL, atol=LOGP_ATOL))
    lanes = int((k[5] != p[5]).any(dim=0).any(dim=0).sum())
    finite = all(bool(torch.isfinite(x).all()) for x in k[:5])
    bits = all(torch.equal(a, b) for a, b in zip(k, p))
    print(f"  {tag}: max err obs {obs_err:.3e} (tol {OBS_ATOL:g}), pre "
          f"{pre_err:.3e} (tol {PRE_ATOL:g}), logp {logp_err:.3e} (rtol "
          f"{LOGP_RTOL:g} atol {LOGP_ATOL:g}), value {value_err:.3e} (tol "
          f"{VALUE_ATOL:g}), reward / max|r| {rew_rel:.3e} (tol "
          f"{REW_RTOL:g}); lanes with divergent stock {lanes}; finite "
          f"{finite}; bit-equal {bits}")
    errs.append(max(obs_err, pre_err, logp_err, value_err))
    if not (obs_err <= OBS_ATOL and pre_err <= PRE_ATOL and logp_ok
            and value_err <= VALUE_ATOL and rew_rel <= REW_RTOL
            and lanes == 0 and finite):
        raise RuntimeError(f"{tag}: outputs disagree")


def phase_policy(B, episodes, seed, errs):
    """Phase 6: the supply-chain kernel's policy modes against plain, at B
    and at a ragged B whose last block holds inactive envs."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout
    from gym_supplychain_tpu_torch.ops.supplychain_collect import (
        launch_supplychain_policy, philox_tables, supplychain_collect_plain)
    from gym_supplychain_tpu_torch.ops.supplychain_dense import (
        dense_descriptor)

    dev = torch.device("cuda")
    print(f"phase 6: supplychain_collect, policy modes, hidden {HIDDEN}, "
          f"mu.w x100, vs plain")
    for env_id, Bc in (("supplychain-linear-v0", B),
                       ("supplychain-ntom-v0", B),
                       ("supplychain-linear-v0", B + RAGGED),
                       ("supplychain-ntom-v0", B + RAGGED)):
        cc = sct.make_chain(env_id, total_time_steps=TRAIN_T)
        S, O, A = episodes * TRAIN_T, cc.obs_dim, cc.A
        model = _policy_model(cc, seed, dev)
        layout = MlpLayout(O, A, HIDDEN)
        args = (torch.as_tensor(dense_descriptor(cc), device=dev), cc, layout,
                torch.as_tensor(layout.ints, device=dev),
                layout.pack(model.flat()), S, Bc)
        dem, lt, eps = philox_tables(cc, seed, range(S), Bc, dev, policy=True)
        k_eps = launch_supplychain_policy(*args, "policy_eps", demands=dem,
                                          leadtimes=lt, eps=eps)
        p_eps = supplychain_collect_plain(cc, episodes, Bc, "policy_eps",
                                          demands=dem, leadtimes=lt, eps=eps,
                                          params=model)
        torch.cuda.synchronize()
        tag = f"{env_id} B={Bc} T={TRAIN_T} episodes={episodes}"
        print(f"  {tag}: {_policy_plan(cc, layout, Bc, 2)}")
        _check_policy(f"(a) {tag} policy_eps kernel vs plain", k_eps, p_eps,
                      errs)
        del p_eps
        k_pol = launch_supplychain_policy(*args, "policy", seed=seed)
        torch.cuda.synchronize()
        _check_policy(f"(b) {tag} policy vs policy_eps on the seed's tables",
                      k_pol, k_eps, errs)
        if Bc != B:
            continue
        k_sm = launch_supplychain_policy(*args, "policy", seed=seed,
                                         sample_major=True)
        torch.cuda.synchronize()
        same = (torch.equal(k_sm[0], k_pol[0].permute(1, 0, 2)
                            .reshape(O, S * B))
                and torch.equal(k_sm[1], k_pol[1].permute(1, 0, 2)
                                .reshape(A, S * B))
                and all(torch.equal(a, b) for a, b in zip(k_sm[2:], k_pol[2:])))
        print(f"  (c) {tag} sample_major equals the default layout, "
              f"reshaped: {same}")
        if not same:
            raise RuntimeError(f"{env_id}: sample_major layout differs")


def phase_ppo_update(seed, errs):
    """Phase 7: the PPO update kernel against plain, both against float64
    autograd, at the trainer's M = T * B samples."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.models.policy import (
        actor_critic_forward, tanh_gaussian_logp)
    from gym_supplychain_tpu_torch.ops import ppo_update as pu

    dev = torch.device("cuda")
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=TRAIN_T)
    O, A, M = cc.obs_dim, cc.A, TRAIN_T * ENVS
    model = _policy_model(cc, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    obs = torch.rand((O, M), generator=g, device=dev) * 2 - 1
    with torch.no_grad():
        mu, log_std, _ = actor_critic_forward(model, obs)
        pre = mu + log_std.exp() * torch.randn((A, M), generator=g,
                                               device=dev)
        # old log-probs of a nearby policy: the ratio clip has both branches
        old = tanh_gaussian_logp(pre, mu, log_std) + 0.3 * torch.randn(
            (M,), generator=g, device=dev)
    adv = torch.randn((M,), generator=g, device=dev)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ret = torch.randn((M,), generator=g, device=dev)
    data = (obs, pre, old, adv, ret)
    gf = pu.make_ppo_update_grads(O, A, HIDDEN, M)
    lk, gk = gf(model, *data)
    lk2, gk2 = gf(model, *data)
    lp, gp = pu.ppo_update_plain(model, *data)
    l64, g64 = pu.ppo_update_plain(model, *(d.double() for d in data))
    torch.cuda.synchronize()
    scale = max(float(x.abs().max()) for x in g64)
    err_k = max(float((a.double() - b).abs().max()) for a, b in zip(gk, g64))
    err_p = max(float((a.double() - b).abs().max()) for a, b in zip(gp, g64))
    lerr_k = abs(float(lk) - float(l64))
    lerr_p = abs(float(lp) - float(l64))
    same = torch.equal(lk, lk2) and all(torch.equal(a, b)
                                        for a, b in zip(gk, gk2))
    finite = bool(torch.isfinite(lk)) and all(bool(torch.isfinite(x).all())
                                              for x in gk)
    ms, _ = _timed(lambda: gf(model, *data), REPS)
    plain_ms, _ = _timed(lambda: pu.ppo_update_plain(model, *data), REPS)
    # back to back, the host runs ahead: the card's time a call, apart from
    # the host's cost to enqueue one (a call timed alone holds some of both)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(BACK_TO_BACK):
        gf(model, *data)
    host_ms = (time.perf_counter() - t0) * 1e3 / BACK_TO_BACK
    end.record()
    torch.cuda.synchronize()
    card_ms = start.elapsed_time(end) / BACK_TO_BACK
    print(f"phase 7: ppo_update, M={M}, O={O}, A={A}, hidden {HIDDEN}, "
          f"against float64 autograd")
    print(f"  gradients: max abs err kernel {err_k:.3e}, plain float32 "
          f"{err_p:.3e} (gate: kernel <= 4 x plain + 1e-7 x max|g| = "
          f"{4 * err_p + 1e-7 * scale:.3e}; max|g| {scale:.3e})")
    print(f"  loss {float(l64):.8f}: err kernel {lerr_k:.3e}, plain float32 "
          f"{lerr_p:.3e}; two launches bit-identical {same}; finite {finite}")
    print(f"  kernel {ms:.3f} ms, plain autograd {plain_ms:.3f} ms per call "
          f"(median of {REPS}, CUDA events)")
    print(f"  kernel, {BACK_TO_BACK} calls back to back: {card_ms:.3f} ms a "
          f"call on the card, {host_ms:.3f} ms a call to enqueue on the host")
    errs.append(err_k)
    if not (err_k <= 4 * err_p + 1e-7 * scale
            and lerr_k <= 4 * lerr_p + 1e-7 * abs(float(l64))
            and same and finite):
        raise RuntimeError("ppo_update: kernel disagrees with float64 autograd "
                           "or does not repeat")
    return dict(ms=ms, plain_ms=plain_ms)


def _train_phases(step, state, reps):
    """Median ms of collect / gae / update / iteration over ``reps``
    iterations after a warm-up, between CUDA events."""
    import torch

    times = {k: [] for k in ("collect", "gae", "update", "iteration")}
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        seed = step.draw_seed(state.gen)
        ev[0].record()
        out = step.collect(state.params, seed)
        ev[1].record()
        _, data = step.prepare(*out)
        ev[2].record()
        losses = step.update(state.params, state.opt, data, state.gen)
        ev[3].record()
        torch.cuda.synchronize()
        if r:
            times["collect"].append(ev[0].elapsed_time(ev[1]))
            times["gae"].append(ev[1].elapsed_time(ev[2]))
            times["update"].append(ev[2].elapsed_time(ev[3]))
            times["iteration"].append(ev[0].elapsed_time(ev[3]))
        if not bool(torch.isfinite(losses).all()):
            raise RuntimeError("trainer: loss is not finite")
    return {k: statistics.median(v) for k, v in times.items()}


def phase_trainer(seed):
    """Phase 8: the trainer's path through the train CLI, then
    ``make_ppo_fused`` timed per phase against the plain trainer."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.learn import ppo, train
    from gym_supplychain_tpu_torch.ops import beergame_collect as bgc
    from gym_supplychain_tpu_torch.ops import ppo_update as pu
    from gym_supplychain_tpu_torch.ops import supplychain_collect as scc

    B, T = ENVS, TRAIN_T
    print(f"phase 8: trainer, supplychain-ntom-v0, B={B}, hidden {HIDDEN}, "
          f"horizon {T}, epochs 2, minibatches 1")
    # launch counts: zero, drive the path, read
    for launcher in (scc.launch_supplychain_collect,
                     scc.launch_supplychain_policy, pu.launch_ppo_update,
                     bgc.launch_beergame_collect):
        launcher.launches = 0
    _, metrics = train.main([
        "--env", "supplychain-ntom-v0", "--envs", str(B), "--hidden",
        *map(str, HIDDEN), "--horizon", str(T), "--iters", "3", "--epochs",
        "2", "--log-every", "1", "--seed", str(seed)])
    torch.cuda.synchronize()
    counts = {"supplychain_collect[policy]":
              scc.launch_supplychain_policy.launches,
              "ppo_update": pu.launch_ppo_update.launches}
    loss = float(metrics["loss"])
    print(f"  train CLI, 3 iterations: final loss {loss:.6f}; launch counts "
          f"{counts}")
    if not (all(counts.values()) and math.isfinite(loss)):
        raise RuntimeError("trainer: the train CLI did not run both kernels")

    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    cfg = ppo.PPOConfig(hidden=HIDDEN, epochs=2, lr=3e-4, fused_update=True)
    res = {}
    for plain, reps in ((False, TRAIN_REPS), (True, PLAIN_TRAIN_REPS)):
        init_fn, step = ppo.make_ppo_fused(cc, B, cfg, noise="prng",
                                           device="cuda", plain=plain)
        res[plain] = _train_phases(step, init_fn(seed), reps)
        r = res[plain]
        print(f"  {'plain ' if plain else 'kernel'} trainer: "
              f"{r['iteration']:.3f} ms per iteration = "
              f"{B * T / r['iteration'] * 1e3:.4e} train env-steps/s; collect "
              f"{r['collect']:.3f}, gae {r['gae']:.3f}, update "
              f"{r['update']:.3f} ms (median of {reps} after a warm-up, CUDA "
              f"events)")

    # one iteration of each from the same weights and seed
    deltas, losses = [], []
    for plain in (False, True):
        init_fn, step = ppo.make_ppo_fused(cc, B, cfg, noise="prng",
                                           device="cuda", plain=plain)
        state = init_fn(seed)
        p0 = torch.cat([x.detach().reshape(-1) for x in state.params.flat()])
        state, m = step(state)
        p1 = torch.cat([x.detach().reshape(-1) for x in state.params.flat()])
        deltas.append((p1 - p0).double())
        losses.append(float(m["loss"]))
    cos = float(deltas[0] @ deltas[1]
                / (deltas[0].norm() * deltas[1].norm() + 1e-300))
    rel = abs(losses[0] - losses[1]) / max(abs(losses[1]), 1e-30)
    print(f"  one iteration from the same weights and seed: loss kernel "
          f"{losses[0]:.8f}, plain {losses[1]:.8f} (relative diff {rel:.3e}, "
          f"tol 1e-4); cosine of the parameter deltas {cos:.8f} (> 0.9999)")
    if not (rel <= 1e-4 and cos > 0.9999):
        raise RuntimeError("trainer: kernel and plain trainers disagree")

    # K1 `policy` alone at the trainer's shape (sample-major, one episode):
    # the kernel's launch between CUDA events, beside the plain version
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout
    from gym_supplychain_tpu_torch.ops.supplychain_dense import (
        dense_descriptor)

    dev = torch.device("cuda")
    model = _policy_model(cc, seed, dev)
    lay = MlpLayout(cc.obs_dim, cc.A, HIDDEN)
    args = (torch.as_tensor(dense_descriptor(cc), device=dev), cc, lay,
            torch.as_tensor(lay.ints, device=dev), lay.pack(model.flat()), T,
            B, "policy")
    k1_ms, _ = _timed(lambda: scc.launch_supplychain_policy(
        *args, seed=seed, sample_major=True), REPS)
    k1_plain, _ = _timed(lambda: scc.supplychain_collect_plain(
        cc, 1, B, "policy", seed=seed, params=model, sample_major=True,
        device=dev), PLAIN_REPS)
    macs = _macs(lay, [0, 1]) * T * B
    print(f"  K1 policy alone, B={B}, T={T}, sample-major: kernel "
          f"{k1_ms:.3f} ms (median of {REPS}) = {k1_ms / T * 1e3:.2f} us a "
          f"step, plain {k1_plain:.1f} ms (median of {PLAIN_REPS}); issue "
          f"bound without FMA {_issue_bound_ms(macs):.4f} ms; "
          f"{_policy_plan(cc, lay, B, 2)}")
    return dict(counts=counts, kernel=res[False], plain=res[True],
                k1=dict(ms=k1_ms, plain_ms=k1_plain))


def _episode_tables(cc, B, seed, device):
    """Random demand [T+1,R,P,B], lead-time [T,K,B] and action [T,A,B]
    tables for one episode."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    put = (lambda x: None if x is None
           else torch.as_tensor(x, device=device).contiguous())
    dem = rs.randint(0, 25, size=(cc.T + 1, cc.R, cc.P, B)).astype(np.float32)
    lt = (rs.randint(1, cc.Lmax + 1, size=(cc.T, cc.K, B)).astype(np.int32)
          if cc.stochastic_leadtimes else None)
    act = (2 * rs.rand(cc.T, cc.A, B) - 1).astype(np.float32)
    act[act < -0.5] = -1.0              # some supplies must not fire
    return put(dem), put(lt), put(act)


def _check_episode(tag, k, p, errs, bits=False):
    """k, p: (rewards [T,B], final stock [N,P,B])."""
    import torch

    rew_abs = float((k[0] - p[0]).abs().max())
    rew_rel = rew_abs / max(float(p[0].abs().max()), 1e-30)
    lanes = int((k[1] != p[1]).any(dim=0).any(dim=0).sum())
    finite = bool(torch.isfinite(k[0]).all())
    same = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    print(f"  {tag}: max reward err / max|r| {rew_rel:.3e} (tol "
          f"{0 if bits else REW_RTOL:g}), lanes with divergent stock {lanes},"
          f" finite {finite}, bit-equal {same}")
    errs.append(rew_abs)
    if not (rew_rel <= REW_RTOL and lanes == 0 and finite
            and (same or not bits)):
        raise RuntimeError(f"{tag}: kernel disagrees")


def phase_episode(B, seed, errs):
    """Phase 9: the episode kernel (K4/K6a) against its plain version at
    B = 4096, T = 360, then the rewards-only sweeps and the timings."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.ops import supplychain_episode as sce
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout

    dev = torch.device("cuda")
    print(f"phase 9: supplychain_episode, B={B}, T=360, modes actions / "
          f"seeded / policy (hidden {HIDDEN}, mu.w x100), vs plain")
    res = {}
    for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0"):
        cc = sct.make_chain(env_id)
        # K6a runs the lane-group kernel, K4 the policy lane kernel
        desc = torch.as_tensor(sce.dense_descriptor(cc), device=dev)
        dem, lt, act = _episode_tables(cc, B, seed, dev)
        model = _policy_model(cc, seed, dev)
        layout = MlpLayout(cc.obs_dim, cc.A, HIDDEN)
        greedy_args = (desc, cc, layout,
                       torch.as_tensor(layout.ints, device=dev),
                       layout.pack(model.flat()), B, dem, lt)
        calls = {
            "actions": (lambda: sce.launch_supplychain_episode(
                desc, cc, B, "actions", dem, lt, actions=act),
                lambda: sce.supplychain_episode_plain(
                    cc, B, "actions", dem, lt, actions=act)),
            "seeded": (lambda: sce.launch_supplychain_episode(
                desc, cc, B, "seeded", dem, lt, seed=seed),
                lambda: sce.supplychain_episode_plain(
                    cc, B, "seeded", dem, lt, seed=seed)),
            "policy": (lambda: sce.launch_supplychain_greedy(*greedy_args),
                       lambda: sce.supplychain_episode_plain(
                           cc, B, "policy", dem, lt, params=model)),
        }
        tag = f"{env_id} B={B} T={cc.T}"
        k, p = calls["actions"][0](), calls["actions"][1]()
        torch.cuda.synchronize()
        _check_episode(f"(a) {tag} actions kernel vs plain", k, p, errs)
        k_s = calls["seeded"][0]()
        k_a = sce.launch_supplychain_episode(
            desc, cc, B, "actions", dem, lt,
            actions=sce.seeded_actions(cc, seed, B, dev))
        torch.cuda.synchronize()
        _check_episode(f"(b) {tag} seeded vs actions on its Philox rows",
                       k_s, k_a, errs, bits=True)
        k, p = calls["policy"][0](), calls["policy"][1]()
        torch.cuda.synchronize()
        _check_episode(f"(c) {tag} greedy policy kernel vs plain", k, p, errs)
        if env_id == "supplychain-ntom-v0":
            for mode, (kern, plain) in calls.items():
                ms, _ = _timed(kern, REPS)
                plain_ms, _ = _timed(plain, PLAIN_REPS)
                res[mode] = dict(ms=ms, plain_ms=plain_ms)
            flops = 2 * _macs(layout, [0]) * cc.T * B
            tables = 4 * (dem.numel() + (lt.numel() if lt is not None else 0))
            out = 4 * (cc.T * B + cc.N * cc.P * B)
            res["actions"]["bound"] = _bound(tables + 4 * act.numel() + out, 0)
            res["seeded"]["bound"] = _bound(tables + out, 0)
            res["policy"]["bound"] = _bound(tables + out + 4 * layout.wsec[0],
                                            flops)
            plans = dict(seeded=_plan(cc, "episode", B),
                         actions=_plan(cc, "episode", B),
                         policy=f"issue bound without FMA "
                                f"{_issue_bound_ms(flops / 2):.4f} ms; "
                                f"{_policy_plan(cc, layout, B, 1)}")
            for mode, r in res.items():
                print(f"  {tag} {mode}: kernel {r['ms']:.3f} ms (median of "
                      f"{REPS}), plain {r['plain_ms']:.1f} ms (median of "
                      f"{PLAIN_REPS}), bound {r['bound'][0]:.4f} ms "
                      f"({r['bound'][1]}): {r['bound'][0] / r['ms']:.2%} of "
                      f"it; {cc.T * B / r['ms'] * 1e3:.4e} env-steps/s; "
                      f"{plans[mode]}")

    # the rewards-only sweeps through the entry point: counts zeroed just
    # before each, read just after
    cc = sct.make_chain("supplychain-ntom-v0")
    dem, lt, act = _episode_tables(cc, B, seed + 1, dev)
    run_seeded, run_actions = sce.make_supplychain_episode(cc, cc.T, B,
                                                           device="cuda")
    for mode, run, last in (("seeded", run_seeded, seed),
                            ("actions", run_actions, act)):
        sce.launch_supplychain_episode.launches = 0
        ms, rew = _timed(lambda: run(dem, lt, last), REPS)
        res[mode]["launches"] = sce.launch_supplychain_episode.launches
        print(f"  sweep through make_supplychain_episode, {mode}: {ms:.3f} ms"
              f" per episode, launches {res[mode]['launches']}, rewards "
              f"{tuple(rew.shape)}, finite {bool(torch.isfinite(rew).all())}"
              f"; {_plan(cc, 'episode', B)}")
        if not (res[mode]["launches"] > 0 and rew.shape == (cc.T, B)
                and bool(torch.isfinite(rew).all())):
            raise RuntimeError(f"episode sweep {mode} failed")
    return res


def phase_eval(seed):
    """Phase 10: the evaluation path: train, checkpoint, exact resume, the
    evaluate CLI with both engines, the base-stock grid, timings."""
    import shutil
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.learn import evaluate, heuristics, train
    from gym_supplychain_tpu_torch.ops import supplychain_episode as sce
    from gym_supplychain_tpu_torch.rng.device import device_episode_tables
    from gym_supplychain_tpu_torch.utils.checkpoint import restore_checkpoint

    B, work = ENVS, ROOT / "gym_supplychain_tpu_torch" / "_build" / "ckpt"
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 10: evaluation, supplychain-ntom-v0, B={B}, hidden "
          f"{HIDDEN}: train (T={TRAIN_T}), checkpoint, resume, evaluate "
          f"(T=360, {EVAL_EPISODES} episodes)")
    base = ["--env", "supplychain-ntom-v0", "--envs", str(B), "--hidden",
            *map(str, HIDDEN), "--horizon", str(TRAIN_T), "--epochs", "2",
            "--log-every", "1", "--seed", str(seed)]
    train.main(base + ["--iters", "2", "--checkpoint-dir", str(work / "a")])
    resumed, _ = train.main(base + ["--iters", "1", "--restore",
                                    str(work / "a"), "--checkpoint-dir",
                                    str(work / "b")])
    full, _ = train.main(base + ["--iters", "3"])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(resumed.params.flat(),
                                                 full.params.flat()))
    print(f"  train CLI 2 iterations + checkpoint + 1 resumed: parameters "
          f"bit-equal to 3 uninterrupted iterations: {same}")
    if not same:
        raise RuntimeError("checkpoint: the resumed run differs")

    argv = ["--restore", str(work / "b"), "--envs", str(B), "--horizon",
            "360", "--episodes", str(EVAL_EPISODES), "--seed", str(seed)]
    sce.launch_supplychain_greedy.launches = 0
    stats_k = evaluate.main(argv + ["--engine", "kernel"])
    torch.cuda.synchronize()
    launches = sce.launch_supplychain_greedy.launches
    stats_s = evaluate.main(argv + ["--engine", "scan"])
    rel = (abs(stats_k["mean_return"] - stats_s["mean_return"])
           / abs(stats_s["mean_return"]))
    ordered = all(s["min_return"] <= s["mean_return"] <= s["max_return"]
                  and all(math.isfinite(v) for v in s.values())
                  for s in (stats_k, stats_s))
    print(f"  evaluate CLI, kernel engine: {stats_k}; greedy kernel launches "
          f"{launches}")
    print(f"  evaluate CLI, scan engine: {stats_s}")
    print(f"  the engines share their inputs (same episode keys and Philox "
          f"rows): mean returns differ by {rel:.3e} relative (tol "
          f"{EVAL_RTOL:g})")
    if not (rel <= EVAL_RTOL and ordered and launches == EVAL_EPISODES):
        raise RuntimeError("evaluation: the engines disagree")

    cc = sct.make_chain("supplychain-ntom-v0")
    t0 = time.perf_counter()
    z, best, scores = heuristics.best_base_stock(cc, B, seed, device="cuda")
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    print(f"  best_base_stock B={B} T=360: best z {z}, mean return "
          f"{best:.1f}, grid {({k: round(v, 1) for k, v in scores.items()})},"
          f" {grid_s:.2f} s (host clock); the greedy policy after 3 "
          f"iterations {stats_k['mean_return']:.1f}")
    if not all(math.isfinite(v) for v in scores.values()):
        raise RuntimeError("base stock: returns not finite")

    params = restore_checkpoint(str(work / "b"))["params"].to("cuda")
    fused = evaluate.make_fused_evaluator(cc, B, HIDDEN, device="cuda")
    scan = evaluate.make_evaluator(cc, B, device="cuda")
    k_ms, _ = _timed(lambda: fused(params, seed, 1), REPS)
    s_ms, _ = _timed(lambda: scan(params, seed, 1), PLAIN_REPS)
    t_ms, _ = _timed(lambda: device_episode_tables((seed, 0), cc, B,
                                                   device="cuda"), REPS)
    for name, ms, reps in (("kernel", k_ms, REPS), ("scan", s_ms, PLAIN_REPS)):
        print(f"  {name} evaluator: {ms:.3f} ms per episode (tables "
              f"included; median of {reps}) = {cc.T * B / ms * 1e3:.4e} "
              f"env-steps/s")
    print(f"  its table draw alone (device_episode_tables): {t_ms:.3f} ms "
          f"an episode (median of {REPS})")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, kernel_ms=k_ms, scan_ms=s_ms,
                tables_ms=t_ms, grid_s=grid_s)


def phase_dense(B, seed):
    """Phase 11: the dense collect kernel (K5) on the three large configs:
    gates against the plain version, then the benchmark's timings
    through ``make_supplychain_dense_collect``."""
    import torch
    from gym_supplychain_tpu_torch.benchmarks import large_topologies as lt
    from gym_supplychain_tpu_torch.ops import supplychain_dense as scd

    dev = torch.device("cuda")
    print(f"phase 11: supplychain_dense (K5), B={B}, T=360, configs "
          f"{list(lt.CONFIGS)}")
    errs = {}
    # (a) `actions` on random tables over 2 episodes, kernel vs plain
    for name in lt.CONFIGS:
        cc = lt.config_chain(name)
        r = lt.parity(cc, B, CHECK_EPISODES, seed, dev)
        print(f"  (a) {name} (N={cc.N}, P={cc.P}, Dmax={cc.Dmax}, A={cc.A}, "
              f"K={cc.K}) actions, {CHECK_EPISODES} episodes: max obs err "
              f"{r['max_abs_obs_err']:.3e} (tol {OBS_ATOL:g}), max reward err "
              f"/ max|r| {r['max_rel_reward_err']:.3e} (tol {REW_RTOL:g}), "
              f"lanes with divergent stock {r['lanes_stock_differs']}, finite "
              f"{r['finite']}")
        errs[name] = max(r["max_abs_obs_err"], r["max_abs_reward_err"])
        if not r["ok"]:
            raise RuntimeError(f"dense {name}: kernel disagrees with plain")
    # (b) `random` against the Philox tables through the plain `actions`
    name = "nperstage-5-4-7-10-x4"
    cc = lt.config_chain(name)
    S = CHECK_EPISODES * cc.T
    desc = torch.as_tensor(scd.dense_descriptor(cc), device=dev)
    k = scd.launch_supplychain_dense(desc, cc, S, B, "random", seed=seed)
    p = scd.supplychain_dense_collect_plain(cc, CHECK_EPISODES, B, "random",
                                            seed=seed, device=dev)
    torch.cuda.synchronize()
    errs_b = []
    _check_sc(f"(b) {name} random vs plain on its Philox tables, "
              f"{CHECK_EPISODES} episodes", k, p, errs_b)
    errs[name] = max(errs[name], errs_b[0])
    del k, p

    # (c) the benchmark's timings: counts zeroed just before each config's
    # run, read just after
    res = {}
    for name in lt.CONFIGS:
        scd.launch_supplychain_dense.launches = 0
        out = lt.run_benchmark("cuda", B, 360, reps=DENSE_REPS,
                               eager_steps=EAGER_STEPS, parity_episodes=0,
                               plain_reps=1, seed=seed, configs=[name])
        launches = scd.launch_supplychain_dense.launches
        r = out[name]
        d, cc = r["dense"], lt.config_chain(name)
        bound = _collect_bound(cc, cc.T, B)
        res[name] = dict(ms=d["ms_1_episode"], plain_ms=d["plain_ms_1_episode"],
                         launches=launches, err=errs[name], bound=bound)
        print(f"  (c) {name}: kernel {d['ms_1_episode']:.3f} ms an episode, "
              f"{d['ms_2_episodes']:.3f} ms two (median of {DENSE_REPS}); "
              f"{d['per_step_ms'] * 1e3:.2f} us a step = "
              f"{d['env_steps_per_s'] or float('nan'):.4e} env-steps/s; bound "
              f"{bound[0]:.4f} ms ({bound[1]}): "
              f"{bound[0] / d['ms_1_episode']:.2%} of it; plain "
              f"{d['plain_ms_1_episode']:.1f} ms an episode; eager env "
              f"{r['eager']['per_step_ms']:.3f} ms a step = "
              f"{r['eager']['env_steps_per_s'] or float('nan'):.4e} "
              f"env-steps/s; launches {launches}")
        if launches == 0:
            raise RuntimeError(f"dense {name}: the benchmark launched no kernel")
    return res


def phase_beergame_episode(B, seed):
    """Phase 12: the beer-game episode sweep (K6b), bit-exact against
    plain at delay 2 and at delay 0 with init_delay 2, at B and at a ragged
    B + 7, then timed through ``beergame_episode`` and alone."""
    import numpy as np
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.benchmarks.beergame import device_ms
    from gym_supplychain_tpu_torch.ops import beergame_episode as bge
    from gym_supplychain_tpu_torch.ops.beergame_collect import beergame_block

    dev = torch.device("cuda")
    spec = sct.make_chain("beergame-v0")
    W, L = spec.weeks, spec.levels
    rs = np.random.RandomState(seed)
    put = lambda x: torch.as_tensor(x, device=dev).contiguous()  # noqa: E731

    def inputs(b):
        return (put(rs.randint(0, 13, size=(W, b)).astype(np.int32)),
                put(rs.randint(0, 16, size=(W, L, b)).astype(np.int32)),
                put(rs.randint(0, 2 * spec.init_inv + 1, size=(L, b))
                    .astype(np.int32)))

    args = inputs(B)
    base = dict(init_ship=spec.init_ship, init_orders=spec.init_orders,
                inv_cost=spec.inv_cost, backlog_cost=spec.backlog_cost)
    print(f"phase 12: beergame_episode (K6b), beergame-v0, B={B}, W={W}, "
          f"per-lane demand, orders and initial inventory, vs plain "
          f"(bit-exact)")
    err = 0
    for b, a in ((B, args), (B + RAGGED, inputs(B + RAGGED))):
        for kw in (dict(delay=spec.delay), dict(delay=0, init_delay=2)):
            k = bge.launch_beergame_episode(*a, **base, **kw)
            p = bge.beergame_episode_plain(*a, **base, **kw)
            torch.cuda.synchronize()
            e = int((k - p).abs().max())
            err = max(err, e)
            print(f"  B={b} {kw}: max reward err {e}, bit-equal "
                  f"{torch.equal(k, p)}")
            if not torch.equal(k, p):
                raise RuntimeError(f"beergame episode B={b} {kw}: not "
                                   "bit-exact")
    bge.launch_beergame_episode.launches = 0
    ms, rew = _timed(lambda: bge.beergame_episode(*args, device="cuda",
                                                  delay=spec.delay, **base),
                     REPS)
    launches = bge.launch_beergame_episode.launches
    alone = device_ms(lambda: bge.launch_beergame_episode(
        *args, delay=spec.delay, **base), REPS)
    plain_ms, _ = _timed(lambda: bge.beergame_episode_plain(
        *args, delay=spec.delay, **base), PLAIN_REPS)
    # demand [W,B], orders [W,L,B] and inventory [L,B] in, rewards [W,B] out
    bound = _bound(4 * B * (2 * W + W * L + L), 0)
    G, E, grid = beergame_block(L, B)
    print(f"  through beergame_episode: {ms:.4f} ms an episode (median of "
          f"{REPS}) = {W * B / ms * 1e3:.4e} env-weeks/s; alone "
          f"{alone:.4f} ms on the card a launch; bound {bound[0]:.5f} ms "
          f"({bound[1]}): {bound[0] / ms:.2%} of it, {bound[0] / alone:.2%} "
          f"of the launch alone; plain {plain_ms:.2f} ms; launches "
          f"{launches}; rewards {tuple(rew.shape)}; {G} lanes an env, {E} "
          f"envs a block, {grid} blocks")
    if not (launches > 0 and rew.shape == (W, B)):
        raise RuntimeError("beergame episode sweep failed")
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=float(err),
                bound=bound)


def _demand_chain(env_id, T=360, **kw):
    import gym_supplychain_tpu_torch as sct

    return sct.make_chain(env_id, total_time_steps=T, **kw)


def _seasonal_dense_chain():
    """Phase 11's [5,4,7,10] x 4 (stochastic lead-times) with seasonal
    demand: 4 peaks between 150 and 250, a normal perturbation of std 10,
    clipped to [0, 400]."""
    return _demand_chain("sc-Nperstage-multiproduct-v0",
                         nodes_per_echelon=[5, 4, 7, 10], num_products=4,
                         stochastic_leadtimes=True, demand_range=(0, 400),
                         demand_std=10, demand_sen_peaks=4,
                         avg_demand_range=(150, 250),
                         demand_perturb_norm=True)


def phase_demand(B, seed, errs):
    """Phase 13: the demand processes drawn in the kernels (normal and
    seasonal), K1 ``random``, K1 ``policy`` and K5 ``random`` against their
    plain versions; K1 and K5 timed beside their uniform-demand chains;
    the train and evaluate CLIs on ``sc-2perstage-seasonal-v0``."""
    import shutil
    import torch
    from gym_supplychain_tpu_torch.learn import evaluate, ppo, train
    from gym_supplychain_tpu_torch.ops import ppo_update as pu
    from gym_supplychain_tpu_torch.ops import supplychain_collect as scc
    from gym_supplychain_tpu_torch.ops import supplychain_dense as scd
    from gym_supplychain_tpu_torch.ops import supplychain_episode as sce
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout
    from gym_supplychain_tpu_torch.rng.device import demand_constants

    dev = torch.device("cuda")
    seasonal = "sc-2perstage-seasonal-v0"
    mp_normal = dict(demand_std=10, demand_perturb_norm=True)
    print("phase 13: demand processes drawn in the kernels, T=360")
    # (a) K1 `random` against plain (obs, stock bit-equal; rewards within
    # REW_RTOL: the cost sum's order) and against `actions` on its Philox
    # tables (bit for bit), one episode
    cases = [(seasonal, {}, B), ("sc-2perstage-multiproduct-v1", {}, B),
             ("sc-2perstage-multiproduct-v1", mp_normal, B),
             ("sc-2perstage-multiproduct-inccosts-v1", dict(demand_std=10),
              B), (seasonal, {}, B + RAGGED)]
    for env_id, kw, b in cases:
        cc = _demand_chain(env_id, **kw)
        S = cc.T
        desc = torch.as_tensor(scd.dense_descriptor(cc), device=dev)
        k = scc.launch_supplychain_collect(desc, cc, S, b, "random", seed=seed)
        dem, lt, act = scc.philox_tables(cc, seed, range(S), b, dev)
        t = scc.launch_supplychain_collect(desc, cc, S, b, "actions",
                                           demands=dem, leadtimes=lt,
                                           actions=act)
        p = scc.supplychain_collect_plain(cc, 1, b, "random", seed=seed,
                                          device=dev)
        torch.cuda.synchronize()
        cfgs = [cc.demand[q if cc.demand_by_product else 0]
                for q in range(cc.P)]
        kinds = [demand_constants(c)["kind"] for c in cfgs]
        in_range = all(
            bool(((dem[:, :, q] >= c.minv) & (dem[:, :, q] <= c.maxv)).all())
            for q, c in enumerate(cfgs))
        tables = all(torch.equal(x, y) for x, y in zip(k, t))
        bits = torch.equal(k[0], p[0]) and torch.equal(k[2], p[2])
        tag = f"(a) {env_id} {kw or ''} B={b} kinds {kinds}"
        print(f"  {tag}: random equals actions on its Philox tables "
              f"{tables}; obs and stock bit-equal to plain {bits}; demand "
              f"in range {in_range}")
        _check_sc(f"{tag} random vs plain", k, p, errs)
        if not (tables and bits and in_range):
            raise RuntimeError(f"{tag}: the demand draw disagrees")
    del k, t, p, dem, lt, act

    # (b) K1 `policy` on the seasonal chain at phase 6's shape and gates
    cc = _demand_chain(seasonal, T=TRAIN_T)
    S = CHECK_EPISODES * TRAIN_T
    model = _policy_model(cc, seed, dev)
    lay = MlpLayout(cc.obs_dim, cc.A, HIDDEN)
    args = (torch.as_tensor(scd.dense_descriptor(cc), device=dev), cc, lay,
            torch.as_tensor(lay.ints, device=dev), lay.pack(model.flat()), S,
            B)
    k = scc.launch_supplychain_policy(*args, "policy", seed=seed)
    dem, lt, eps = scc.philox_tables(cc, seed, range(S), B, dev, policy=True)
    t = scc.launch_supplychain_policy(*args, "policy_eps", demands=dem,
                                      leadtimes=lt, eps=eps)
    p = scc.supplychain_collect_plain(cc, CHECK_EPISODES, B, "policy",
                                      seed=seed, params=model, device=dev)
    torch.cuda.synchronize()
    tag = f"(b) {seasonal} B={B} T={TRAIN_T} episodes={CHECK_EPISODES}"
    _check_policy(f"{tag} policy kernel vs plain", k, p, errs)
    same = all(torch.equal(x, y) for x, y in zip(k, t))
    print(f"  {tag}: policy equals policy_eps on its Philox tables {same}")
    if not same:
        raise RuntimeError(f"{tag}: policy differs from policy_eps")
    del k, t, p, dem, lt, eps

    # (c) K5 `random` on phase 11's largest chain with seasonal demand
    cc = _seasonal_dense_chain()
    S = CHECK_EPISODES * cc.T
    desc = torch.as_tensor(scd.dense_descriptor(cc), device=dev)
    k = scd.launch_supplychain_dense(desc, cc, S, B, "random", seed=seed)
    p = scd.supplychain_dense_collect_plain(cc, CHECK_EPISODES, B, "random",
                                            seed=seed, device=dev)
    torch.cuda.synchronize()
    dense_errs = []
    _check_sc(f"(c) nperstage-5-4-7-10-x4 seasonal random vs plain, "
              f"{CHECK_EPISODES} episodes", k, p, dense_errs)
    errs += dense_errs
    del k, p

    # (d) timings through the entry points, counts zeroed just before each
    # run and read just after: K1 `random` at B, MAIN_EPISODES episodes,
    # the seasonal chain beside sc-2perstage-v0 (the same graph, uniform
    # demand) and the normal multiproduct-v1; K5 seasonal beside phase 11's
    # uniform chain, one episode
    res = {}
    k1 = [(seasonal, {}), ("sc-2perstage-v0", {}),
          ("sc-2perstage-multiproduct-v1", mp_normal)]
    for env_id, kw in k1:
        cc = _demand_chain(env_id, **kw)
        S = MAIN_EPISODES * cc.T
        run = scc.make_supplychain_collect(cc, cc.T, B, mode="random",
                                           episodes=MAIN_EPISODES,
                                           device="cuda")
        scc.launch_supplychain_collect.launches = 0
        ms, out = _timed(lambda: run(seed), REPS)
        launches = scc.launch_supplychain_collect.launches
        plain_ms, _ = _timed(lambda: scc.supplychain_collect_plain(
            cc, MAIN_EPISODES, B, "random", seed=seed, device=dev), 1)
        finite = bool(torch.isfinite(out[0]).all()
                      and torch.isfinite(out[1]).all())
        name = env_id + (" std=10 normal" if kw else "")
        res[name] = dict(ms=ms, plain_ms=plain_ms, launches=launches,
                         bound=_collect_bound(cc, S, B), kernel="collect")
        print(f"  (d) K1 random {name}, B={B}, {MAIN_EPISODES} episodes: "
              f"kernel {ms:.3f} ms = {S * B / ms * 1e3:.4e} env-steps/s "
              f"(median of {REPS}), plain {plain_ms:.1f} ms; bound "
              f"{res[name]['bound'][0]:.4f} ms ({res[name]['bound'][1]}): "
              f"{res[name]['bound'][0] / ms:.2%} of it; launches {launches}; "
              f"finite {finite}; {_plan(cc, 'collect', B)}")
        if not (launches > 0 and finite):
            raise RuntimeError(f"K1 random {name} failed")
    for name, cc in (("nperstage-5-4-7-10-x4 seasonal",
                      _seasonal_dense_chain()),
                     ("nperstage-5-4-7-10-x4 uniform", _demand_chain(
                         "sc-Nperstage-multiproduct-v0",
                         nodes_per_echelon=[5, 4, 7, 10], num_products=4,
                         stochastic_leadtimes=True))):
        run = scd.make_supplychain_dense_collect(cc, cc.T, B, mode="random",
                                                 device="cuda")
        scd.launch_supplychain_dense.launches = 0
        ms, out = _timed(lambda: run(seed), DENSE_REPS)
        launches = scd.launch_supplychain_dense.launches
        plain_ms, _ = _timed(lambda: scd.supplychain_dense_collect_plain(
            cc, 1, B, "random", seed=seed, device=dev), 1)
        res[name] = dict(ms=ms, plain_ms=plain_ms, launches=launches,
                         bound=_collect_bound(cc, cc.T, B), kernel="dense")
        print(f"  (d) K5 random {name}, B={B}, 1 episode: kernel {ms:.3f} ms "
              f"(median of {DENSE_REPS}), plain {plain_ms:.1f} ms; bound "
              f"{res[name]['bound'][0]:.4f} ms: "
              f"{res[name]['bound'][0] / ms:.2%} of it; launches {launches}")
        if launches == 0:
            raise RuntimeError(f"K5 random {name} failed")
    for a, b in ((seasonal, "sc-2perstage-v0"),
                 ("nperstage-5-4-7-10-x4 seasonal",
                  "nperstage-5-4-7-10-x4 uniform")):
        print(f"  the draw's cost: {a} {res[a]['ms']:.3f} ms against {b} "
              f"{res[b]['ms']:.3f} ms ({res[a]['ms'] / res[b]['ms']:.3f}x)")

    # (e) the train CLI on the seasonal chain at phase 8's shape, then the
    # trainer's phases; (f) the evaluate CLI, both engines, on its
    # checkpoint, one episode
    work = ROOT / "gym_supplychain_tpu_torch" / "_build" / "ckpt_seasonal"
    shutil.rmtree(work, ignore_errors=True)
    for launcher in (scc.launch_supplychain_policy, pu.launch_ppo_update):
        launcher.launches = 0
    _, metrics = train.main([
        "--env", seasonal, "--envs", str(B), "--hidden", *map(str, HIDDEN),
        "--horizon", str(TRAIN_T), "--iters", "3", "--epochs", "2",
        "--log-every", "1", "--seed", str(seed), "--checkpoint-dir",
        str(work)])
    torch.cuda.synchronize()
    counts = {"supplychain_collect[policy]":
              scc.launch_supplychain_policy.launches,
              "ppo_update": pu.launch_ppo_update.launches}
    loss = float(metrics["loss"])
    print(f"  (e) train CLI on {seasonal}, B={B}, hidden {HIDDEN}, T="
          f"{TRAIN_T}, 3 iterations: final loss {loss:.6f}; launch counts "
          f"{counts}")
    if not (all(counts.values()) and math.isfinite(loss)):
        raise RuntimeError("seasonal trainer: the train CLI did not run both "
                           "kernels")
    cfg = ppo.PPOConfig(hidden=HIDDEN, epochs=2, lr=3e-4, fused_update=True)
    init_fn, step = ppo.make_ppo_fused(_demand_chain(seasonal, T=TRAIN_T), B,
                                       cfg, noise="prng", device="cuda")
    tr = _train_phases(step, init_fn(seed), TRAIN_REPS)
    print(f"  (e) the trainer on {seasonal}: {tr['iteration']:.3f} ms per "
          f"iteration = {B * TRAIN_T / tr['iteration'] * 1e3:.4e} train "
          f"env-steps/s; collect {tr['collect']:.3f}, gae {tr['gae']:.3f}, "
          f"update {tr['update']:.3f} ms (median of {TRAIN_REPS})")
    argv = ["--env", seasonal, "--restore", str(work), "--envs", str(B),
            "--horizon", "360", "--episodes", "1", "--seed", str(seed)]
    sce.launch_supplychain_greedy.launches = 0
    stats_k = evaluate.main(argv + ["--engine", "kernel"])
    torch.cuda.synchronize()
    launches = sce.launch_supplychain_greedy.launches
    stats_s = evaluate.main(argv + ["--engine", "scan"])
    rel = (abs(stats_k["mean_return"] - stats_s["mean_return"])
           / abs(stats_s["mean_return"]))
    print(f"  (f) evaluate CLI on {seasonal}: kernel engine {stats_k} "
          f"(greedy kernel launches {launches}); scan engine {stats_s}; "
          f"mean returns differ by {rel:.3e} relative (tol {EVAL_RTOL:g})")
    shutil.rmtree(work, ignore_errors=True)
    if not (rel <= EVAL_RTOL and launches == 1):
        raise RuntimeError("seasonal evaluation: the engines disagree")
    return dict(timings=res, dense_err=max(dense_errs), train=tr,
                train_counts=counts)


def _kernel_lines(res, tr, upd, ep, ev, dn, bge, dm, sc_errs, bg_errs,
                  pol_errs, pu_errs, ep_errs, dm_errs):
    """The ``kernels`` summary: each kernel with its main-path launches,
    its error against plain, its time, its plain version's and its bound
    at the main path's shapes (no single PyTorch call computes any of these
    functions, so ``library_ms`` is null)."""
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout

    src = "gym_supplychain_tpu_torch/csrc/"
    sc_pallas = "gym_supplychain_tpu/ops/supplychain_pallas.py"
    B, lines = ENVS, []

    def line(name, source, replaces, launches, err, ms, plain_ms, bound):
        lines.append(dict(name=name, route="cuda", source=src + source,
                          replaces=replaces, launches=launches,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound[0], bound_by=bound[1],
                          library_ms=None))

    for env_id, r in res.items():
        S = r["S"]
        if env_id.startswith("beergame"):
            spec = sct.make_chain(env_id)
            # demand [S,B] in; obs [S,L,B] and reward [S,B] out, int32
            bound = _bound(4 * S * B * (2 + spec.levels), 0)
            line(f"beergame_collect[{env_id}]", "beergame_collect.cu",
                 "gym_supplychain_tpu/ops/beergame_pallas.py:149",
                 r["launches"], max(bg_errs + [r["max_abs_err"]]), r["ms"],
                 r["plain_ms"], bound)
        else:
            cc = sct.make_chain(env_id)
            bound = _collect_bound(cc, S, B)
            line(f"supplychain_collect[{env_id}]", "supplychain_lanes.cu",
                 f"{sc_pallas}:791", r["launches"],
                 max(sc_errs + [r["max_abs_err"]]), r["ms"], r["plain_ms"],
                 bound)
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=TRAIN_T)
    lay = MlpLayout(cc.obs_dim, cc.A, HIDDEN)
    M = TRAIN_T * B
    # policy collection alone: weights in; obs, pre, logp, value, reward,
    # stock out
    line("supplychain_collect[policy]", "supplychain_policy.cu",
         f"{sc_pallas}:791", tr["counts"]["supplychain_collect[policy]"],
         max(pol_errs), tr["k1"]["ms"], tr["k1"]["plain_ms"],
         _bound(4 * (sum(lay.wsec) + M * (cc.obs_dim + cc.A + 3)
                     + cc.N * cc.P * B),
                2 * _macs(lay, [0, 1]) * M))
    # update: obs, pre and three [M] rows and the weights in, the gradients
    # out; forward, weight gradients, and input gradients past layer 0
    macs = 3 * _macs(lay, [0, 1]) - cc.obs_dim * 2 * HIDDEN[0]
    line("ppo_update", "ppo_update.cu",
         "gym_supplychain_tpu/ops/ppo_update_pallas.py:91",
         tr["counts"]["ppo_update"], max(pu_errs), upd["ms"],
         upd["plain_ms"],
         _bound(4 * (M * (cc.obs_dim + cc.A + 3) + 2 * lay.n_params),
                2 * macs * M))
    for mode in ("seeded", "actions", "policy"):
        r = ep[mode]
        line(f"supplychain_episode[{mode}]",
             "supplychain_policy.cu" if mode == "policy"
             else "supplychain_episode.cu",
             f"{sc_pallas}:736",
             ev["launches"] if mode == "policy" else r["launches"],
             max(ep_errs), r["ms"], r["plain_ms"], r["bound"])
    for name, r in dn.items():
        line(f"supplychain_dense_collect[{name}]", "supplychain_dense.cu",
             "gym_supplychain_tpu/ops/supplychain_pallas_dense.py:470",
             r["launches"], r["err"], r["ms"], r["plain_ms"], r["bound"])
    line("beergame_episode", "beergame_collect.cu",
         "gym_supplychain_tpu/ops/beergame_pallas.py:125", bge["launches"],
         bge["err"], bge["ms"], bge["plain_ms"], bge["bound"])
    # phase 13: K1 and K5 on normal and seasonal demand (and the uniform
    # chains timed beside them), the draw at ops/supplychain_pallas.py:107
    for name, r in dm["timings"].items():
        if r["kernel"] == "collect":
            line(f"supplychain_collect[{name}]", "supplychain_lanes.cu",
                 f"{sc_pallas}:791", r["launches"], max(dm_errs), r["ms"],
                 r["plain_ms"], r["bound"])
        else:
            line(f"supplychain_dense_collect[{name}]", "supplychain_dense.cu",
                 "gym_supplychain_tpu/ops/supplychain_pallas_dense.py:470",
                 r["launches"], dm["dense_err"], r["ms"], r["plain_ms"],
                 r["bound"])
    return lines


def _refuse(reason):
    """Why the run stops before phase 1, on stdout and on stderr."""
    print(reason, flush=True)
    print(reason, file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "gym_supplychain_tpu_torch").is_dir():
        _refuse("gym_supplychain_tpu_torch not found beside chip_smoke.py")
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        _refuse("CUDA is not available: nothing to run")
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
    for kernel in ("ppo_grad_kernel", "sc_lane_kernel",
                   "sc_policy_lane_kernel", "bg_collect_kernel"):
        rows = _build.ptxas_report(kernel)
        if not rows:
            raise RuntimeError(f"no ptxas report for {kernel}")
        for r in rows:
            print(f"  ptxas {r['function']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, spill loads "
                  f"{r['spill_loads']} B, stack {r['stack']} B a thread")

    B = ENVS
    chains = {env_id: sct.make_chain(env_id)
              for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0")}
    sc_errs, bg_errs, pol_errs, pu_errs, ep_errs = [], [], [], [], []
    phase_supplychain(chains, B, CHECK_EPISODES, args.seed, sc_errs)
    phase_beergame(B, CHECK_EPISODES, args.seed, bg_errs)
    res = phase_main_path(B, MAIN_EPISODES, args.seed, REPS)
    phase_policy(B, CHECK_EPISODES, args.seed, pol_errs)
    upd = phase_ppo_update(args.seed, pu_errs)
    tr = phase_trainer(args.seed)
    ep = phase_episode(B, args.seed, ep_errs)
    ev = phase_eval(args.seed)
    dn = phase_dense(B, args.seed)
    bge = phase_beergame_episode(B, args.seed)
    dm_errs = []
    dm = phase_demand(B, args.seed, dm_errs)

    kernels = _kernel_lines(res, tr, upd, ep, ev, dn, bge, dm, sc_errs,
                            bg_errs, pol_errs, pu_errs, ep_errs, dm_errs)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
