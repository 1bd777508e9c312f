#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the kernels from ``gym_supplychain_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the main paths
through the package's entry points, timing kernel and plain version with
CUDA events: trajectory collection at 4096 envs for
``supplychain-linear-v0``, ``supplychain-ntom-v0`` and ``beergame-v0``, and
the PPO trainer on ``supplychain-ntom-v0`` at 4096 envs, hidden (128, 128),
horizon 60.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits nonzero:
  1. device, power limit, torch/CUDA/nvcc versions; kernel build time
  2. supply-chain kernel, ``actions`` mode, against plain (linear, ntom)
  3. supply-chain kernel, ``random`` mode, against plain; marginals
  4. beer-game kernel: v0 random and actions, v2 per-lane actions
  5. the collection path: env-steps/s of kernel and plain, launch counts
  6. supply-chain kernel, policy modes, against plain (linear, ntom):
     ``policy_eps`` on Philox tables, ``policy`` against ``policy_eps``,
     the ``sample_major`` layout against the default one
  7. the PPO update kernel against plain, both against float64 autograd,
     at M = 60 * 4096 samples; two launches must give the same bits
  8. the trainer's path: the train CLI, then ``make_ppo_fused`` timed per
     phase (collect / gae / update) against the plain trainer, whose first
     iteration must match the kernel trainer's
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
TRAIN_T = 60               # phases 6-8: the trainer's horizon (one episode)
HIDDEN = (128, 128)        # phases 6-8: the trainer's widths
PRE_ATOL, VALUE_ATOL = 1e-4, 1e-4   # policy outputs (the JAX collect tests')
LOGP_RTOL, LOGP_ATOL = 1e-4, 1e-3
TRAIN_REPS, PLAIN_TRAIN_REPS = 5, 3  # phase 8: timed iterations (median)


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
    """Phase 6: the supply-chain kernel's policy modes against plain."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout
    from gym_supplychain_tpu_torch.ops.supplychain_collect import (
        chain_descriptor, launch_supplychain_policy, philox_tables,
        supplychain_collect_plain)

    dev = torch.device("cuda")
    print(f"phase 6: supplychain_collect, policy modes, hidden {HIDDEN}, "
          f"mu.w x100, vs plain")
    for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0"):
        cc = sct.make_chain(env_id, total_time_steps=TRAIN_T)
        S, O, A = episodes * TRAIN_T, cc.obs_dim, cc.A
        model = _policy_model(cc, seed, dev)
        layout = MlpLayout(O, A, HIDDEN)
        args = (torch.as_tensor(chain_descriptor(cc), device=dev), cc, layout,
                torch.as_tensor(layout.ints, device=dev),
                layout.pack(model.flat()), S, B)
        dem, lt, eps = philox_tables(cc, seed, range(S), B, dev, policy=True)
        k_eps = launch_supplychain_policy(*args, "policy_eps", demands=dem,
                                          leadtimes=lt, eps=eps)
        p_eps = supplychain_collect_plain(cc, episodes, B, "policy_eps",
                                          demands=dem, leadtimes=lt, eps=eps,
                                          params=model)
        torch.cuda.synchronize()
        tag = f"{env_id} B={B} T={TRAIN_T} episodes={episodes}"
        _check_policy(f"(a) {tag} policy_eps kernel vs plain", k_eps, p_eps,
                      errs)
        k_pol = launch_supplychain_policy(*args, "policy", seed=seed)
        torch.cuda.synchronize()
        _check_policy(f"(b) {tag} policy vs policy_eps on the seed's tables",
                      k_pol, k_eps, errs)
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
    print(f"phase 7: ppo_update, M={M}, O={O}, A={A}, hidden {HIDDEN}, "
          f"against float64 autograd")
    print(f"  gradients: max abs err kernel {err_k:.3e}, plain float32 "
          f"{err_p:.3e} (gate: kernel <= 4 x plain + 1e-7 x max|g| = "
          f"{4 * err_p + 1e-7 * scale:.3e}; max|g| {scale:.3e})")
    print(f"  loss {float(l64):.8f}: err kernel {lerr_k:.3e}, plain float32 "
          f"{lerr_p:.3e}; two launches bit-identical {same}; finite {finite}")
    print(f"  kernel {ms:.3f} ms, plain autograd {plain_ms:.3f} ms per call "
          f"(median of {REPS}, CUDA events)")
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
    return dict(counts=counts, kernel=res[False], plain=res[True])


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
    sc_errs, bg_errs, pol_errs, pu_errs = [], [], [], []
    phase_supplychain(chains, B, CHECK_EPISODES, args.seed, sc_errs)
    phase_beergame(B, CHECK_EPISODES, args.seed, bg_errs)
    res = phase_main_path(B, MAIN_EPISODES, args.seed, REPS)
    phase_policy(B, CHECK_EPISODES, args.seed, pol_errs)
    upd = phase_ppo_update(args.seed, pu_errs)
    tr = phase_trainer(args.seed)

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
    kernels.append(dict(
        name="supplychain_collect[policy]", route="cuda",
        source=src + "supplychain_collect.cu",
        replaces="gym_supplychain_tpu/ops/supplychain_pallas.py:791",
        launches=tr["counts"]["supplychain_collect[policy]"],
        max_abs_err=max(pol_errs), ms=tr["kernel"]["collect"],
        plain_ms=tr["plain"]["collect"]))
    kernels.append(dict(
        name="ppo_update", route="cuda", source=src + "ppo_update.cu",
        replaces="gym_supplychain_tpu/ops/ppo_update_pallas.py:91",
        launches=tr["counts"]["ppo_update"], max_abs_err=max(pu_errs),
        ms=upd["ms"], plain_ms=upd["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
