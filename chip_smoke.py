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
beer-game episode sweep at 4096 envs, collection, training and
evaluation on normal and seasonal demand drawn in the kernels, the bf16
learner (the update kernel's tensor-core mode), the beer game's
trainer, evaluator and order-up-to baseline, the host-parity MT19937
streams with the reference-compatible single envs, data-parallel
training over processes with the bf16 update on every net it takes, and
tensor-parallel training over the mesh's model axis, and learning: the
JAX package's sc-2perstage learning bar on the scan trainer, the fused
engine and the bf16 learner.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits nonzero:
  1. device, power limit, torch/CUDA/nvcc versions; kernel build time;
     ptxas's registers and spills of the update kernel (both modes), of
     every instance
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
     time a call alone and back to back behind a sleep kernel (card and
     host apart)
  8. the trainer's path: the train CLI, then ``make_ppo_fused`` timed per
     phase (collect / gae / update) against the plain trainer, whose first
     iteration must match the kernel trainer's; the program's spans on the
     kernel trainer (``utils/profiling.py``): an iteration's host time with
     them off and on, in turns, each span's host time, ``ppo.gae`` inside
     ``ppo.prepare``, no record dropped, the weight packs an iteration (one
     for K1, one a K2 call), and in a traced iteration the device
     operations launched under ``ppo.gae``, which must be
     ``learn/ppo.py``'s count (8 a step, 5 around the loop); then K1
     ``policy`` alone at the trainer's shape beside its plain version
  9. the episode kernel against plain at B = 4096, T = 360 (linear, ntom):
     ``actions`` on random tables, ``seeded`` against ``actions`` fed its
     Philox rows (bit for bit), greedy ``policy`` at hidden (128, 128);
     then the rewards-only sweeps through ``make_supplychain_episode``,
     with the lane-group kernel's lanes, envs a block and grid
  10. the evaluation path: the train CLI writes a checkpoint, a resumed run
     must repeat the uninterrupted one bit for bit, the evaluate CLI runs
     both engines on it (B = 4096, T = 360, 4 episodes; they share their
     inputs, so their mean returns agree within 1e-5), ``best_base_stock``
     runs at the same size; both evaluators are timed (the kernel
     evaluator packs its weights once and reuses the pack), and the kernel
     evaluator's table draw alone, the draw kernel beside the plain draw;
     the draw kernel's tables must equal the plain draw's bit for bit at
     B = 4096, T = 360 and launch once an evaluator call, and the draw's
     span (``rng.episode_tables``) must hold one device operation in each
     traced call
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
  14. the bf16 learner and the beer game: K2's bf16 mode at phase 7's
     shape against its plain bf16 version, on phase 7's inputs and on the
     same from the trainer's initial weights (loss within 1e-3 relative,
     each gradient tensor within 1e-2 * its max, flat cosine >= 0.9999,
     two launches bit-identical; cosine to the float32 K2 >= 0.999 from
     the trainer's weights, and no more than 1e-4 below the plain bf16
     version's from phase 7's, whose x100 mu head amplifies bf16's
     rounding), timed beside the float32 K2 and the same bf16 products
     unfused through ``torch.matmul`` (a yardstick the port never calls)
     in turns; the train CLI with ``--learner-dtype bf16``
     at phase 8's shape (K1 ``policy`` and the bf16 K2 launched) and both
     learners' phases, the first iteration's parameter change against the
     float32 learner's (cosine >= 0.9); the train CLI on ``beergame-v2``
     at 4096 envs, ``make_beergame_ppo`` on the v2 ranges timed an
     iteration, the greedy evaluator, the order-up-to grid and
     ``compare_baseline_beergame`` at 20 iterations
  15. the host-parity MT19937 streams: (a) ``supplychain-ntom-v0`` on
     4096 lanes seeded seed + lane, T = 360, 8 episodes: the native
     generator's table fill (the phase fails on the NumPy fallback), the
     eager ``VecSupplyChainEnv(rng_mode="host-lanes")`` and K1 ``actions``
     on the same tables and scripted actions, at phase 2's gates, both
     timed (K1 with the fill and upload counted in and without); (b) lanes
     0, 1 and 4095 of (a)'s first two episodes against
     ``SupplyChainNtoMEnv(seed=seed + lane)`` on the card (stock
     bit-equal, obs atol 1e-6); (c) ``VecBeerGameEnv(v2=True,
     rng_mode="host")`` at 1024 lanes (demand [0, 12), delays [0, 4), 35
     weeks, 8 episodes) bit-exact against K3 on its tables, lane 0 against
     ``BeerGameEnv2(seed=seed)``; (d) the committed reference recordings
     (``tests/data``: the ntom and multiproduct scenarios, the beer game's)
     through the strict-obs single envs on the card at
     ``tests/test_recorded_trajectory.py``'s tolerances, single-env
     steps/s
  16. (a) K2's bf16 mode on every net of ``RESTORED_NETS`` (the packed-dH
     wgmma instance and the mma.sync kernel), at the trainer's M against
     its plain bf16 version at phase 14's gates, timed; the train CLI with
     ``--learner-dtype bf16`` on two of them (both bf16 kernels launched);
     (b) ``benchmarks/multihost_scaling.py`` on ``supplychain-ntom-v0`` at
     8192 global envs (``BASELINE.json``'s north-star config), 1 process,
     then 2 ranks of 4096 sharing ``cuda:0`` over gloo: the first
     iteration's loss, mean reward and mean value within 1e-4 x max(1,
     |v|) of 1 process's, the ranks' parameters bit-equal, a checkpoint
     the 2 ranks wrote resuming bit for bit, global train env-steps/s of
     both (two processes time-sharing one card: not a scaling figure) and
     the all-reduce's ms an iteration; (c) one ``ppo-ntom-fused``
     iteration traced by ``utils/profiling.py::trace``, the card's busy
     share of the traced window (the union of its kernels' intervals)
  17. tensor parallelism over the mesh's model axis, two ranks sharing
     ``cuda:0`` over gloo, through ``benchmarks/multihost_scaling.py``:
     (a) the scan trainer on ``supplychain-ntom-v0`` at 4096 global envs,
     hidden (128, 128), rollout 16, epochs 2, on a ``1x2`` mesh, with
     autograd, K2 and K2 bf16 on the gathered net (each launched on every
     rank), 3 iterations each: the first iteration within 1e-4 x max(1,
     |v|) of 1 process, the replicated leaves and the gathered net
     bit-equal on the ranks; ``make_ppo_fused`` on the same ``1x2`` mesh
     with its parameters whole (K1 ``policy`` and K2 launched on every
     rank), held the same way; (b) the beer game's trainer on beergame-v2
     with the stochastic ranges at 4096 global envs on ``2x1`` and ``1x2``:
     the same tolerance, each rank's tables its lanes of the global draw;
     (c) checkpoints of each trainer: ``1x2`` resumed bit for bit,
     restored into 1 process as the gathered net, a 1-process file
     restored into each rank's rows (the whole net for the fused trainer);
     ms an iteration beside 1 process, the data and model groups'
     collectives (ms a call, calls an iteration); K2 and K2 bf16 at the
     path's shape (M = 16 x 4096) against their plain versions, timed
  18. learning on the card: the JAX package's sc-2perstage bar
     (``tests/test_vector_learn.py::test_supplychain_ppo_beats_base_stock``:
     T = 60, 256 envs, hidden (64, 64), lr 3e-3, 4 epochs, 220 iterations)
     through ``learn.compare_baseline`` at ``--seed`` (``learn/bars.py``)
     on three engines: the scan trainer (autograd; its greedy return must
     beat base stock at z = 2.0 by > 5%, the JAX bar: one draw of a seed,
     so a miss there is a draw first; the 5-iteration parity below,
     deterministic on the card, is what detects a fault), the fused
     engine (K1 ``policy``
     collection and K2, an episode an iteration) and the bf16 learner (K1
     ``policy`` and K2 bf16), each of which must beat the tuned base-stock
     grid, with the greedy rollout kernel (K4) and the scan evaluator
     within 1e-5 on the final policy; the greedy return every 22
     iterations, the margins, the train seconds and the launches of K1
     ``policy``, K2, K2 bf16 and K4 a run (each fused run launches K1 220
     times and its update kernel 880); the fused engine on the kernels
     against the same trainer on their plain versions over 5 iterations
     from one seed (cumulative parameter change cosine >= 0.999, mean
     reward and loss within 1e-4 relative); then those four kernels at
     the phase's shapes against their plain versions, timed
The line before the last is a JSON summary of the kernels, each with its
bound: the larger of the bytes it must move over 3.35 TB/s and the float32
operations it must do over 67 TFLOP/s, the bf16 K2's over the tensor
cores' 989 TFLOP/s (the H100 SXM data sheet at 700 W;
the env step's scalar operations are not counted, so the bound stays a
lower bound); beside K1 ``policy`` and K4 the text prints the bound without
FMA contraction, which their float rules forbid (twice the MLP's).  The
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the package beside it, it prints the reason and no result and exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
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
PLAIN_REPS = 2             # phases 5, 9-10: timed plain calls (median)
EVAL_RTOL = 1e-5           # phase 10: kernel vs scan evaluator, mean return
RAGGED = 7                 # phases 4, 6, 12: B + 7 envs, a ragged last block
DENSE_REPS = 3             # phase 11: timed calls of the dense kernel (median)
EAGER_STEPS = 10           # phase 11: the eager env's slope, 10 vs 20 steps
PEAK_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
PEAK_BF16 = 989e12         # H100 SXM bf16 tensor cores, dense
SLEEP_CYCLES = 200_000_000  # ~0.1 s: longer than the host takes to enqueue
                            # the back-to-back calls
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
HOST_EPISODES = 8          # phase 15: consecutive episodes of the host streams
HOST_LANES = (0, 1, ENVS - 1)   # phase 15: lanes held against single envs
BG_HOST_ENVS = 1024        # phase 15: the beer game's host mode
REF_OBS_ATOL = 5e-7        # phase 15: the recorded reference's tolerances
REF_REW_RTOL, REF_REW_ATOL = 1e-6, 1e-2
# phase 16: the nets of K2's bf16 mode that the wgmma kernel's first
# instances did not hold (the packed-dH instance <64,3,64,32> or the mma.sync
# kernel runs them): the chain whose obs and actions they take, and their
# hidden widths
RESTORED_NETS = (("sc-2perstage-multiproduct-v0", (64, 64, 64)),
                 ("sc-2perstage-multiproduct-v0", (32, 32, 32)),
                 ("sc-2perstage-multiproduct-v0", (64, 128)),
                 ("sc-2perstage-multiproduct-v0", (128, 64)),
                 ("sc-Nperstage-multiproduct-v0", (64,)),
                 ("sc-Nperstage-multiproduct-v0", (32, 32)),
                 ("supplychain-ntom-v0", (256,)))
MULTI_ENVS = 2 * ENVS      # phase 16: BASELINE.json's ntom at 8192 envs
MULTI_ITERS = 5            # phase 16: timed iterations a process count
MULTI_TOL = 1e-4           # phase 16: 2 ranks against 1 process, x max(1, |v|)
TP_HORIZON = 360           # phase 17: the train CLI's default horizon
TP_ITERS = 2               # phase 17: timed iterations after the first
TP_SCAN = ("scan", "scan-k2", "scan-k2-bf16")   # autograd, K2, K2 bf16
TP_CASES = TP_SCAN + ("fused", "beergame")      # phase 17's trainers on 1x2
# phase 18: the JAX package's sc-2perstage learning bar
# (tests/test_vector_learn.py::test_supplychain_ppo_beats_base_stock, as
# gym_supplychain_tpu_torch/learn/bars.py gives it to the compare CLI) on
# three engines; the scan trainer is held to the bar (5% over base stock at
# z = 2.0), the fused engines to beating the tuned grid
LEARN_BAR = "sc2perstage"
LEARN_PARITY_ITERS = 5     # the fused engine's kernels against plain
LEARN_ENGINES = (("scan", "scan", None), ("fused", "fused", None),
                 ("fused-bf16", "fused", "bf16"))


def _cmd(args):
    res = subprocess.run(args, capture_output=True, text=True, timeout=60)
    return (res.stdout or res.stderr).strip()


def _launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far (the counter
    ``launch.<kernel>`` of ``utils/profiling.py``)."""
    from gym_supplychain_tpu_torch.utils.profiling import counters

    return counters().get("launch." + kernel, 0)


def _span_launches(path, name):
    """The device operations launched inside each instance of the
    program's span ``name``, in order, in a Chrome trace that
    ``utils.profiling.trace`` wrote: an operation's ``correlation`` id
    names the runtime call that launched it, whose start lies in the
    span."""
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in xs if e.get("cat") == "user_annotation"
                   and e.get("name") == "gsc." + name)
    launched = {(e.get("args") or {}).get("correlation"): float(e["ts"])
                for e in xs if e.get("cat") in ("cuda_runtime",
                                                "cuda_driver")}
    counts = [0] * len(spans)
    for e in xs:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched.get((e.get("args") or {}).get("correlation"))
        for i, (a, b) in enumerate(spans):
            if t is not None and a <= t <= b:
                counts[i] += 1
                break
    return counts


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


def _bound(n_bytes, n_flops, peak_flops=PEAK_FLOPS):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``n_bytes`` and do ``n_flops`` operations at ``peak_flops``
    (float32 outside the tensor cores unless given)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / peak_flops
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
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

    dev = torch.device("cuda")
    runs, plans = {}, {}
    for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0"):
        cc = sct.make_chain(env_id)
        plans[env_id] = "; " + _plan(cc, "collect", B)
        runs[env_id] = ("supplychain_collect",
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
        "beergame_collect",
        lambda seed: bg_run(spec.demand, seed), S_bg,
        lambda: bgc.beergame_collect_plain(
            spec.weeks, spec.levels, B, episodes, "random",
            demand=bg_dem[:, None].expand(spec.weeks, B).repeat(episodes, 1),
            seed=seed, **bg_kw))

    # launch counts: zero, drive the main path, read
    reset_counters()
    results = {}
    for env_id, (kernel, run, S, _) in runs.items():
        before = _launches(kernel)
        ms, out = _timed(lambda: run(seed), reps)
        results[env_id] = dict(ms=ms, launches=_launches(kernel) - before,
                               out=out, S=S)
    counts = {"supplychain_collect": _launches("supplychain_collect"),
              "beergame_collect": _launches("beergame_collect")}

    print(f"phase 5: main path, mode 'random', B={B}, episodes={episodes}, "
          f"median of {reps} (plain: {PLAIN_REPS}) after a warm-up (CUDA "
          f"events)")
    for env_id, (_, _, S, plain) in runs.items():
        r = results[env_id]
        plain_ms, p = _timed(plain, PLAIN_REPS)
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


def _policy_model(cc, seed, dev, hidden=HIDDEN):
    import torch
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig

    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, hidden),
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


def _update_data(cc, model, M, seed, dev):
    """Phase 7's update inputs: obs in [-1, 1), pre-tanh actions from the
    policy, old log-probs of a nearby policy (the ratio clip has both
    branches), normalized advantages, returns."""
    import torch
    from gym_supplychain_tpu_torch.models.policy import (
        actor_critic_forward, tanh_gaussian_logp)

    O, A = cc.obs_dim, cc.A
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


def _back_to_back(fn, n):
    """(the card's ms a call, the host's ms to enqueue one) over ``n``
    calls enqueued without a sync behind a sleep kernel: the host gets
    ahead while the card sleeps, so the first is the card's time apart
    from the host's even for a call the host takes longer to enqueue than
    the card to run (a call timed alone holds some of both)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host_ms


def _f32_update(cc, model, M, hidden, seed):
    """K2 (float32) on phase 7's kind of inputs at M samples against its
    plain version, both against float64 autograd; timed.  Returns the
    errors, the gate's verdict and the times."""
    import torch
    from gym_supplychain_tpu_torch.ops import ppo_update as pu

    data = _update_data(cc, model, M, seed, model.v.w.device)
    gf = pu.make_ppo_update_grads(cc.obs_dim, cc.A, hidden, M)
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
    card_ms, host_ms = _back_to_back(lambda: gf(model, *data), BACK_TO_BACK)
    ok = (err_k <= 4 * err_p + 1e-7 * scale
          and lerr_k <= 4 * lerr_p + 1e-7 * abs(float(l64))
          and same and finite)
    return dict(err_k=err_k, err_p=err_p, scale=scale, loss=float(l64),
                lerr_k=lerr_k, lerr_p=lerr_p, same=same, finite=finite,
                ok=ok, ms=ms, plain_ms=plain_ms, card_ms=card_ms,
                host_ms=host_ms)


def phase_ppo_update(seed, errs):
    """Phase 7: the PPO update kernel against plain, both against float64
    autograd, at the trainer's M = T * B samples."""
    import torch
    import gym_supplychain_tpu_torch as sct

    dev = torch.device("cuda")
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=TRAIN_T)
    O, A, M = cc.obs_dim, cc.A, TRAIN_T * ENVS
    r = _f32_update(cc, _policy_model(cc, seed, dev), M, HIDDEN, seed)
    print(f"phase 7: ppo_update, M={M}, O={O}, A={A}, hidden {HIDDEN}, "
          f"against float64 autograd")
    print(f"  gradients: max abs err kernel {r['err_k']:.3e}, plain float32 "
          f"{r['err_p']:.3e} (gate: kernel <= 4 x plain + 1e-7 x max|g| = "
          f"{4 * r['err_p'] + 1e-7 * r['scale']:.3e}; max|g| "
          f"{r['scale']:.3e})")
    print(f"  loss {r['loss']:.8f}: err kernel {r['lerr_k']:.3e}, plain "
          f"float32 {r['lerr_p']:.3e}; two launches bit-identical "
          f"{r['same']}; finite {r['finite']}")
    print(f"  kernel {r['ms']:.3f} ms, plain autograd {r['plain_ms']:.3f} ms "
          f"per call (median of {REPS}, CUDA events)")
    print(f"  kernel, {BACK_TO_BACK} calls back to back: {r['card_ms']:.3f} "
          f"ms a call on the card, {r['host_ms']:.3f} ms a call to enqueue "
          f"on the host")
    errs.append(r["err_k"])
    if not r["ok"]:
        raise RuntimeError("ppo_update: kernel disagrees with float64 autograd "
                           "or does not repeat")
    return dict(ms=r["ms"], plain_ms=r["plain_ms"])


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


def _flat_cos(a, b):
    """Cosine of two lists of tensors, flattened, in float64."""
    import torch

    a = torch.cat([x.reshape(-1).double() for x in a])
    b = torch.cat([x.reshape(-1).double() for x in b])
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def _first_step(init_fn, step, seed):
    """([the parameters' change], loss) over one iteration of a trainer
    from its initial state."""
    import torch

    state = init_fn(seed)
    p0 = torch.cat([x.detach().reshape(-1) for x in state.params.flat()])
    state, m = step(state)
    p1 = torch.cat([x.detach().reshape(-1) for x in state.params.flat()])
    return [p1 - p0], float(m["loss"])


def _program_spans(step, state, cfg, T, reps):
    """The program's spans and counters on the fused trainer (phase 8)."""
    import tempfile
    import torch
    from gym_supplychain_tpu_torch.utils import profiling

    def iteration():
        seed = step.draw_seed(state.gen)
        _, data = step.prepare(*step.collect(state.params, seed))
        step.update(state.params, state.opt, data, state.gen)
        torch.cuda.synchronize()

    iteration()
    profiling.take()
    profiling.reset_counters()
    host_ms = {False: [], True: []}
    span_ms, nested = {}, True
    for r in range(reps):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            was = profiling.enable(on)
            t0 = time.perf_counter()
            iteration()
            host_ms[on].append(1e3 * (time.perf_counter() - t0))
            profiling.enable(was)
            sums = {}
            for rec in profiling.take():
                sums[rec.name] = (sums.get(rec.name, 0.0)
                                  + (rec.end_ns - rec.start_ns) / 1e6)
                if rec.name == "ppo.gae":
                    nested &= rec.parent == "ppo.prepare"
            for k, v in sums.items():
                span_ms.setdefault(k, []).append(v)
    got = profiling.counters()
    packs = (1 + cfg.epochs * cfg.minibatches) * 2 * reps
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            iteration()
            iteration()
        gae = _span_launches(os.path.join(tmp, "trace.rank0.json"),
                             "ppo.gae")
    want = 8 * T + 5
    med = {k: round(statistics.median(v), 4)
           for k, v in sorted(span_ms.items())}
    print(f"  program spans, kernel trainer: an iteration "
          f"{statistics.median(host_ms[False]):.3f} ms off, "
          f"{statistics.median(host_ms[True]):.3f} ms on (host clock, "
          f"median of {reps} each, in turns); each span's host ms an "
          f"iteration {med}; "
          f"ppo.gae inside ppo.prepare {nested}; counters {got} over "
          f"{2 * reps} iterations (weight packs expected {packs}); device "
          f"operations under ppo.gae in 2 traced iterations {gae} "
          f"(learn/ppo.py: 8 x {T} + 5 = {want})")
    if not (nested and set(span_ms) == {
            "ppo.collect", "ops.collect", "ops.pack", "ppo.prepare",
            "ppo.gae", "ppo.normalize", "ppo.update", "ppo.grads",
            "ops.ppo_update", "ppo.clip", "ppo.adam"}
            and not got.get("spans.dropped")
            and got.get("ops.pack") == packs
            and not got.get("ops.pack_reused") and gae[-1:] == [want]):
        raise RuntimeError("trainer: the program's spans or counters are "
                           "not where they belong")
    return dict(off_ms=statistics.median(host_ms[False]),
                on_ms=statistics.median(host_ms[True]), gae_launches=gae[-1])


def phase_trainer(seed):
    """Phase 8: the trainer's path through the train CLI, then
    ``make_ppo_fused`` timed per phase against the plain trainer."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.learn import ppo, train
    from gym_supplychain_tpu_torch.ops import supplychain_collect as scc
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

    B, T = ENVS, TRAIN_T
    print(f"phase 8: trainer, supplychain-ntom-v0, B={B}, hidden {HIDDEN}, "
          f"horizon {T}, epochs 2, minibatches 1")
    # launch counts: zero, drive the path, read
    reset_counters()
    _, metrics = train.main([
        "--env", "supplychain-ntom-v0", "--envs", str(B), "--hidden",
        *map(str, HIDDEN), "--horizon", str(T), "--iters", "3", "--epochs",
        "2", "--log-every", "1", "--seed", str(seed)])
    torch.cuda.synchronize()
    counts = {"supplychain_collect[policy]":
              _launches("supplychain_policy"),
              "ppo_update": _launches("ppo_update")}
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
        if not plain:
            spans = _program_spans(step, init_fn(seed), cfg, T, reps)

    # one iteration of each from the same weights and seed
    deltas, losses = [], []
    for plain in (False, True):
        delta, loss = _first_step(*ppo.make_ppo_fused(
            cc, B, cfg, noise="prng", device="cuda", plain=plain), seed)
        deltas.append(delta)
        losses.append(loss)
    cos = _flat_cos(deltas[0], deltas[1])
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
                k1=dict(ms=k1_ms, plain_ms=k1_plain), spans=spans)


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
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

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
        reset_counters()
        ms, rew = _timed(lambda: run(dem, lt, last), REPS)
        res[mode]["launches"] = _launches("supplychain_episode")
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
    from gym_supplychain_tpu_torch.rng.device import (device_episode_tables,
                                                       episode_tables_plain)
    import tempfile
    from gym_supplychain_tpu_torch.utils.checkpoint import restore_checkpoint
    from gym_supplychain_tpu_torch.utils.profiling import (counters,
                                                           reset_counters,
                                                           trace)

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
    reset_counters()
    stats_k = evaluate.main(argv + ["--engine", "kernel"])
    torch.cuda.synchronize()
    launches = _launches("supplychain_greedy")
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
    reset_counters()
    k_ms, _ = _timed(lambda: fused(params, seed, 1), REPS)
    packs = counters()
    # the draw kernel against its plain version on one key, bit for bit
    key = (seed, 0)
    dem, lt = device_episode_tables(key, cc, B, device="cuda")
    dem_p, lt_p = episode_tables_plain(key, cc, B, device="cuda")
    draw_err = max((dem - dem_p).abs().max().item(),
                   (lt - lt_p).abs().max().item())
    draw_equal = torch.equal(dem, dem_p) and torch.equal(lt, lt_p)
    print(f"  the draw kernel's tables at B={B}, T={cc.T} against the plain "
          f"draw's on the same key: equal {draw_equal}, max abs err "
          f"{draw_err:g}; launch.episode_tables over the kernel evaluator's "
          f"{REPS + 1} calls {packs.get('launch.episode_tables', 0)}")
    if not (draw_equal and packs.get("launch.episode_tables") == REPS + 1):
        raise RuntimeError("evaluation: the draw kernel differs from the "
                           "plain draw or is not one launch a call")
    # demands [T+1,R,P,B] float32 and lead-times [T,K,B] int32 written
    draw_bytes = 4 * (dem.numel() + lt.numel())
    del dem, lt, dem_p, lt_p
    s_ms, _ = _timed(lambda: scan(params, seed, 1), PLAIN_REPS)
    t_ms, _ = _timed(lambda: device_episode_tables((seed, 0), cc, B,
                                                   device="cuda"), REPS)
    tp_ms, _ = _timed(lambda: episode_tables_plain((seed, 0), cc, B,
                                                   device="cuda"), REPS)
    for name, ms, reps in (("kernel", k_ms, REPS), ("scan", s_ms, PLAIN_REPS)):
        print(f"  {name} evaluator: {ms:.3f} ms per episode (tables "
              f"included; median of {reps}) = {cc.T * B / ms * 1e3:.4e} "
              f"env-steps/s")
    print(f"  its table draw alone (device_episode_tables, the kernel): "
          f"{t_ms:.3f} ms an episode; the plain draw (episode_tables_plain) "
          f"on the card {tp_ms:.3f} ms (medians of {REPS})")
    # the profiler can drop a traced stretch's first operations, so the
    # first of the three traced calls is not held to the count
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            for _ in range(3):
                fused(params, seed, 1)
        draw = _span_launches(os.path.join(tmp, "trace.rank0.json"),
                              "rng.episode_tables")
    print(f"  kernel evaluator's weight packs over {REPS + 1} calls: "
          f"ops.pack {packs.get('ops.pack', 0)}, ops.pack_reused "
          f"{packs.get('ops.pack_reused', 0)}; device operations under "
          f"rng.episode_tables in 3 traced calls {draw} (the draw kernel: "
          f"1 a call)")
    if not (packs.get("ops.pack") == 1 and packs.get("ops.pack_reused")
            == REPS and len(draw) == 3 and draw[0] <= 1
            and draw[1:] == [1, 1]):
        raise RuntimeError("evaluation: the weight pack is not reused or the "
                           "draw is not one operation a call")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, kernel_ms=k_ms, scan_ms=s_ms,
                tables_ms=t_ms, tables_plain_ms=tp_ms, grid_s=grid_s,
                draw_launches=draw[-1],
                draw_kernel=dict(launches=packs["launch.episode_tables"],
                                 err=draw_err, bound=_bound(draw_bytes, 0)))


def phase_dense(B, seed):
    """Phase 11: the dense collect kernel (K5) on the three large configs:
    gates against the plain version, then the benchmark's timings
    through ``make_supplychain_dense_collect``."""
    import torch
    from gym_supplychain_tpu_torch.benchmarks import large_topologies as lt
    from gym_supplychain_tpu_torch.ops import supplychain_dense as scd
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

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
        reset_counters()
        out = lt.run_benchmark("cuda", B, 360, reps=DENSE_REPS,
                               eager_steps=EAGER_STEPS, parity_episodes=0,
                               plain_reps=1, seed=seed, configs=[name])
        launches = _launches("supplychain_dense")
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
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

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
    reset_counters()
    ms, rew = _timed(lambda: bge.beergame_episode(*args, device="cuda",
                                                  delay=spec.delay, **base),
                     REPS)
    launches = _launches("beergame_episode")
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
    from gym_supplychain_tpu_torch.ops import supplychain_collect as scc
    from gym_supplychain_tpu_torch.ops import supplychain_dense as scd
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout
    from gym_supplychain_tpu_torch.rng.device import demand_constants
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

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
        reset_counters()
        ms, out = _timed(lambda: run(seed), REPS)
        launches = _launches("supplychain_collect")
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
        reset_counters()
        ms, out = _timed(lambda: run(seed), DENSE_REPS)
        launches = _launches("supplychain_dense")
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
    reset_counters()
    _, metrics = train.main([
        "--env", seasonal, "--envs", str(B), "--hidden", *map(str, HIDDEN),
        "--horizon", str(TRAIN_T), "--iters", "3", "--epochs", "2",
        "--log-every", "1", "--seed", str(seed), "--checkpoint-dir",
        str(work)])
    torch.cuda.synchronize()
    counts = {"supplychain_collect[policy]":
              _launches("supplychain_policy"),
              "ppo_update": _launches("ppo_update")}
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
    reset_counters()
    stats_k = evaluate.main(argv + ["--engine", "kernel"])
    torch.cuda.synchronize()
    launches = _launches("supplychain_greedy")
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


def _bf16_products(model, obs):
    """The bf16 products of one K2 call, unfused, through ``torch.matmul``
    on bf16 operands (float32 accumulation, bf16 results): each net's
    forward, every weight gradient and the input gradients past layer 0,
    with the head's output standing for its gradient.  A yardstick of what
    a library does with the same products; the port never calls it."""
    import torch
    from gym_supplychain_tpu_torch.models.policy import split_params

    actor, mu, critic, v, _ = split_params(model)
    nets = [[w.detach().to(torch.bfloat16) for w, _ in layers + [head]]
            for layers, head in ((actor, mu), (critic, v))]
    x = obs.to(torch.bfloat16)

    def run():
        for ws in nets:
            acts = [x]
            for w in ws:
                acts.append(torch.matmul(w, acts[-1]))
            dy = acts[-1]
            for l in range(len(ws) - 1, -1, -1):
                torch.matmul(dy, acts[l].t())
                if l:
                    dy = torch.matmul(ws[l].t(), dy)

    return run


def phase_bf16_beergame(seed):
    """Phase 14: K2's bf16 mode against its plain version at phase 7's
    shape and beside the float32 K2; the train CLI with the bf16 learner at
    phase 8's shape; the beer game's trainer, evaluator, order-up-to grid
    and comparison CLI."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.learn import (compare_baseline_beergame,
                                                 evaluate, heuristics, ppo,
                                                 train)
    from gym_supplychain_tpu_torch.ops import ppo_update as pu
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

    dev = torch.device("cuda")
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=TRAIN_T)
    O, A, M, B = cc.obs_dim, cc.A, TRAIN_T * ENVS, ENVS
    print("phase 14: the bf16 learner and the beer game's trainer")

    # (a) K2 bf16 against its plain bf16 version on phase 7's inputs, and
    # on the same inputs from the trainer's initial weights
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig

    bf16 = torch.bfloat16
    gf = pu.make_ppo_update_grads(O, A, HIDDEN, M, compute_dtype=bf16)
    gf32 = pu.make_ppo_update_grads(O, A, HIDDEN, M)
    models = {
        "phase 7's weights (mu x100)": _policy_model(cc, seed, dev),
        "the trainer's initial weights": ActorCritic(
            MLPConfig(O, A, HIDDEN), torch.Generator().manual_seed(seed),
            dev)}
    ok, err = True, 0.0
    for tag, model in models.items():
        data = _update_data(cc, model, M, seed, dev)
        lk, gk = gf(model, *data)
        lk2, gk2 = gf(model, *data)
        lp, gp = pu.ppo_update_plain(model, *data, compute_dtype=bf16)
        _, g32 = gf32(model, *data)
        torch.cuda.synchronize()
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        per = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(gk, gp))
        err = max([err] + [float((a - b).abs().max())
                           for a, b in zip(gk, gp)])
        cos_p, cos_32 = _flat_cos(gk, gp), _flat_cos(gk, g32)
        cos_p32 = _flat_cos(gp, g32)
        same = torch.equal(lk, lk2) and all(torch.equal(a, b)
                                            for a, b in zip(gk, gk2))
        # the float32 cosine: >= 0.999 from the trainer's weights; from
        # phase 7's, whose x100 head amplifies bf16's rounding, the plain
        # bf16 version's own cosine less 1e-4
        bar = 0.999 if tag.startswith("the trainer") else cos_p32 - 1e-4
        print(f"  (a) ppo_update bf16 (tensor cores), M={M}, hidden {HIDDEN},"
              f" {tag}, against its plain bf16 version: loss "
              f"{float(lk):.8f} / {float(lp):.8f} ({rel:.3e} relative, tol "
              f"1e-3); largest tensor error / its max {per:.3e} (tol 1e-2); "
              f"flat cosine {cos_p:.8f} (>= 0.9999); two launches "
              f"bit-identical {same}; cosine to the float32 K2 {cos_32:.8f} "
              f"(>= {bar:.8f}; the plain bf16 version's {cos_p32:.8f})")
        ok &= (rel <= 1e-3 and per <= 1e-2 and cos_p >= 0.9999
               and cos_32 >= bar and same)
    if not ok:
        raise RuntimeError("ppo_update bf16: kernel disagrees with its plain "
                           "version or does not repeat")
    model = models["phase 7's weights (mu x100)"]
    data = _update_data(cc, model, M, seed, dev)
    ms, _ = _timed(lambda: gf(model, *data), REPS)
    plain_ms, _ = _timed(lambda: pu.ppo_update_plain(
        model, *data, compute_dtype=bf16), REPS)
    fns = {"float32": lambda: gf32(model, *data),
           "bf16": lambda: gf(model, *data),
           "matmul": _bf16_products(model, data[0])}
    b2b = {name: [] for name in fns}
    fns["matmul"]()                        # the library's first-call set-up
    for name in ("float32", "bf16", "matmul", "matmul", "bf16",
                 "float32"):                                   # in turns
        b2b[name].append(_back_to_back(fns[name], BACK_TO_BACK))
    turns = {k: [(round(c, 4), round(h, 4)) for c, h in v]
             for k, v in b2b.items()}
    med = {k: statistics.median(c for c, _ in v) for k, v in b2b.items()}
    lay = MlpLayout(O, A, HIDDEN)
    macs = 3 * _macs(lay, [0, 1]) - O * 2 * HIDDEN[0]
    n_bytes = 4 * (M * (O + A + 3) + 2 * lay.n_params)
    bound = _bound(n_bytes, 2 * macs * M, PEAK_BF16)
    print(f"  (a) bf16 kernel {ms:.3f} ms, plain bf16 autograd "
          f"{plain_ms:.3f} ms per call (median of {REPS}); {BACK_TO_BACK} "
          f"back to back, in turns (card ms, host ms a call; matmul: the "
          f"same bf16 products unfused through torch.matmul): {turns}; "
          f"medians on the card: bf16 kernel {med['bf16']:.4f} ms, "
          f"torch.matmul yardstick {med['matmul']:.4f} ms, float32 kernel "
          f"{med['float32']:.4f} ms")
    print(f"  (a) bounds: {2 * macs * M / 1e9:.2f} GFLOP over 989 TFLOP/s "
          f"bf16 = {1e3 * 2 * macs * M / PEAK_BF16:.4f} ms; {n_bytes / 1e6:.1f}"
          f" MB over 3.35 TB/s = {1e3 * n_bytes / PEAK_BYTES:.4f} ms; the "
          f"float32 FLOP bound {1e3 * 2 * macs * M / PEAK_FLOPS:.4f} ms")
    upd = dict(ms=ms, plain_ms=plain_ms, err=err, bound=bound)

    # (b) the train CLI with the bf16 learner at phase 8's shape, then the
    # trainer's phases beside the float32 one, and the first iteration's
    # parameter change against the float32 trainer's from the same state
    reset_counters()
    _, metrics = train.main([
        "--env", "supplychain-ntom-v0", "--envs", str(B), "--hidden",
        *map(str, HIDDEN), "--horizon", str(TRAIN_T), "--iters", "3",
        "--epochs", "2", "--log-every", "1", "--seed", str(seed),
        "--learner-dtype", "bf16"])
    torch.cuda.synchronize()
    counts = {"supplychain_collect[policy]":
              _launches("supplychain_policy"),
              "ppo_update_bf16": _launches("ppo_update_bf16"),
              "ppo_update": _launches("ppo_update")}
    loss = float(metrics["loss"])
    print(f"  (b) train CLI --learner-dtype bf16, ntom, B={B}, T={TRAIN_T}, 3"
          f" iterations: final loss {loss:.6f}; launch counts {counts}")
    if not (counts["supplychain_collect[policy]"]
            and counts["ppo_update_bf16"] and not counts["ppo_update"]
            and math.isfinite(loss)):
        raise RuntimeError("bf16 trainer: the train CLI did not run K1 "
                           "policy and the bf16 K2 alone")
    phases, deltas = {}, {}
    for name, dtype in (("float32", None), ("bf16", bf16)):
        cfg = ppo.PPOConfig(hidden=HIDDEN, epochs=2, lr=3e-4,
                            fused_update=True, learner_dtype=dtype)
        init_fn, step = ppo.make_ppo_fused(cc, B, cfg, noise="prng",
                                           device="cuda")
        phases[name] = _train_phases(step, init_fn(seed), TRAIN_REPS)
        deltas[name] = _first_step(init_fn, step, seed)[0]
        r = phases[name]
        print(f"  (b) {name} learner: {r['iteration']:.3f} ms per iteration ="
              f" {B * TRAIN_T / r['iteration'] * 1e3:.4e} train env-steps/s; "
              f"collect {r['collect']:.3f}, gae {r['gae']:.3f}, update "
              f"{r['update']:.3f} ms (median of {TRAIN_REPS})")
    cos = _flat_cos(deltas["bf16"], deltas["float32"])
    print(f"  (b) first iteration from the same state: cosine of the "
          f"parameter deltas, bf16 against float32, {cos:.6f} (>= 0.9)")
    if not cos >= 0.9:
        raise RuntimeError("bf16 trainer: its update leaves the float32 one")

    # (c) the beer game: the train CLI on beergame-v2, the trainer's ms an
    # iteration, the greedy evaluator and the order-up-to grid on the v2
    # ranges, the comparison CLI at a few iterations
    _, metrics = train.main([
        "--env", "beergame-v2", "--envs", str(B), "--iters", "5",
        "--log-every", "1", "--seed", str(seed)])
    loss = float(metrics["loss"])
    print(f"  (c) train CLI --env beergame-v2, B={B}, 5 iterations: final "
          f"loss {loss:.6f}, mean reward {float(metrics['mean_reward']):.3f}")
    v2 = dict(customer_demand=(0, 12), shipment_delays=(0, 4), v2=True,
              max_stock=100, exceeded_capacity_penalty=100)
    cfg = ppo.PPOConfig(rollout_steps=35, hidden=(64, 64), lr=1e-3, epochs=4,
                        ent_coef=5e-3)
    init_fn, step = ppo.make_beergame_ppo(B, cfg, device="cuda", **v2)
    state = init_fn(seed)
    it_ms, _ = _timed(lambda: step(state), TRAIN_REPS)
    ev = evaluate.make_beergame_evaluator(B, device="cuda", **v2)
    ev_ms, stats = _timed(lambda: ev(state.params, seed + 1, 2), PLAIN_REPS)
    t0 = time.perf_counter()
    best, (heur, heur_std), _ = heuristics.best_beergame_base_stock(
        B, seed, device="cuda", episodes=2, **v2)
    grid_s = time.perf_counter() - t0
    print(f"  (c) make_beergame_ppo, v2 ranges, B={B}, hidden (64, 64), 35 "
          f"weeks a rollout, 4 epochs: {it_ms:.3f} ms an iteration = "
          f"{B * 35 / it_ms * 1e3:.4e} train env-steps/s (median of "
          f"{TRAIN_REPS}); greedy evaluator, 2 episodes: {ev_ms:.3f} ms, "
          f"mean return {float(stats['mean_return']):.2f}; order-up-to grid "
          f"(19 targets, 2 episodes): best S={best}, mean {heur:.2f}, std "
          f"{heur_std:.2f}, {grid_s:.2f} s")
    report = compare_baseline_beergame.main([
        "--envs", "1024", "--iters", "20", "--eval-episodes", "2",
        "--seed", str(seed)])
    if not (math.isfinite(loss) and math.isfinite(float(
            stats["mean_return"])) and math.isfinite(heur)
            and "ppo_beats_order_up_to_by" in report):
        raise RuntimeError("beer game: a trainer, evaluator or baseline "
                           "result is not finite")
    return dict(upd=upd, counts=counts, phases=phases)


# the recorded reference episodes phase 15 replays (tests/data/*.npz), with
# the scenarios' classes, arguments and seeds of tests/fixture_scenarios.py
# (which builds JAX envs, so it is not imported here)
_RECORDED_SC = {
    "ntom_stochastic": (3, "SupplyChainNtoMEnv", dict(total_time_steps=60)),
    "multiproduct_constant_leadtimes": (
        1, "SupplyChainMultiProduct", dict(total_time_steps=40)),
}


def _recorded_beergame():
    """name -> (class, positional args, keyword args, actions per episode):
    ``beergame_scenarios()`` of tests/fixture_scenarios.py."""
    import numpy as np

    demand = [3, 7, 1, 9, 5, 2, 8, 6, 4, 10] * 2
    delays = [2, 0, 1, 3, 0, 2, 1, 0, 3, 2] * 2
    custom = {'levels': 3, 'customer_demand': demand,
              'shipment_delays': delays, 'initial_inventory': [5, 8, 11],
              'inv_cost': 2, 'backlog_cost': 5, 'initial_shipment_value': 3,
              'initial_orders_value': 2}
    rs = np.random.RandomState(3)
    return {
        "v0_default": ("BeerGameEnv", (), {}, [
            np.random.RandomState(0).randint(0, 16, size=(35, 4))]),
        "v0_custom_zero_delays": ("BeerGameEnv", (custom,), {}, [
            np.random.RandomState(7).randint(0, 12, size=(len(demand), 3))]),
        "v2_stochastic_streams": ("BeerGameEnv2", (), dict(
            customer_demand=(0, 12), shipment_delays=(0, 4), max_stock=40,
            exceeded_capacity_penalty=37, seed=11), [
            rs.randint(0, 20, size=(35, 4)) for _ in range(3)]),
    }


def _gate(what, ok):
    if not ok:
        raise RuntimeError(f"phase 15: {what}")


def _host_lanes(B, seed, dev):
    """Phase 15 (a), (b): ntom on B MT19937 lanes, eager and through K1."""
    import numpy as np
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch import native
    from gym_supplychain_tpu_torch.core.step import make_supplychain_kernels
    from gym_supplychain_tpu_torch.envs.vector import VecSupplyChainEnv
    from gym_supplychain_tpu_torch.ops import supplychain_collect as scc
    from gym_supplychain_tpu_torch.ops.supplychain_dense import (
        dense_descriptor)
    from gym_supplychain_tpu_torch.rng.host import BatchHostRNG

    cc = sct.make_chain("supplychain-ntom-v0")
    T, E = cc.T, HOST_EPISODES
    S = E * T
    rng = BatchHostRNG(cc, [seed + b for b in range(B)])
    _gate(f"the native MT19937 generator did not build: "
          f"{native.build_error()}", rng.backend == "native")
    tables, fill = [], []
    for _ in range(E):
        t0 = time.perf_counter()
        tables.append(rng.episode_tables())
        fill.append(1e3 * (time.perf_counter() - t0))
    # K1 reads row s at step s: an episode's first T demand rows (row T
    # only feeds the terminal obs, which the auto-reset replaces) and its T
    # lead-time rows, episode after episode
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    dem = torch.cat([torch.as_tensor(d[:T]).to(dev) for d, _ in tables]
                    ).to(torch.float32).contiguous()
    lt = torch.cat([torch.as_tensor(lt).to(dev) for _, lt in tables]
                   ).to(torch.int32).contiguous()
    torch.cuda.synchronize(dev)
    upload_ms = 1e3 * (time.perf_counter() - t0)
    g = torch.Generator(device=dev).manual_seed(seed)
    act = 2 * torch.rand((S, cc.A, B), generator=g, device=dev) - 1
    act[act < -0.5] = -1.0              # some supplies must not fire
    fill_ms = statistics.mean(fill)
    print(f"phase 15 (a): supplychain-ntom-v0, {B} MT19937 lanes (seed + "
          f"lane), T={T}, {E} episodes; tables by the {rng.backend} "
          f"generator: {fill_ms:.3f} ms an episode (mean of {E}; "
          f"{', '.join(f'{x:.2f}' for x in fill)}), put on the card "
          f"{upload_ms:.2f} ms for all {E}")

    run = scc.make_supplychain_collect(cc, T, B, mode="actions", episodes=E,
                                       device=dev)
    k_ms, _ = _timed(lambda: run(dem, lt, act), REPS)
    desc = torch.as_tensor(dense_descriptor(cc), device=dev)
    k_obs, k_rew, k_stock = scc.launch_supplychain_collect(
        desc, cc, S, B, "actions", demands=dem, leadtimes=lt, actions=act)

    # the eager host-lanes env on the same streams and actions, its
    # outputs kept on the card and held against K1's after the timed run
    vec = VecSupplyChainEnv(cc=cc, batch_size=B, rng_mode="host-lanes",
                            seed=seed, device=dev)
    _gate("the host-lanes env's generator is not native",
          vec.lane_rng.backend == "native")
    _, step_k, _ = make_supplychain_kernels(cc, device=dev)
    env_obs = torch.empty_like(k_obs)
    env_rew = torch.empty_like(k_rew)
    env_stock = torch.empty((2 * T,) + tuple(k_stock.shape), device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    env_obs[0] = vec.reset()
    for s in range(S - 1):
        out = vec.step(act[s])
        env_obs[s + 1] = out.obs
        env_rew[s] = out.reward
        if s < 2 * T:
            env_stock[s] = vec.state.env.stock
    # the last step through the engine itself: the env's auto-reset would
    # replace the final stock K1 returns
    env, out = step_k(vec.state.env, act[S - 1])
    env_rew[S - 1] = out.reward
    torch.cuda.synchronize(dev)
    eager_ms = 1e3 * (time.perf_counter() - t0)
    o_err, r_err, rew_rel, stock_lanes, finite = _compare(
        (env_obs, env_rew, env.stock), (k_obs, k_rew, k_stock))
    k_rate = S * B / k_ms * 1e3
    with_fill = k_ms + E * fill_ms + upload_ms
    print(f"  K1 'actions' on the host tables: {k_ms:.3f} ms (median of "
          f"{REPS}) = {k_rate:.4e} env-steps/s; with the table fill and "
          f"the upload counted in {with_fill:.3f} ms = "
          f"{S * B / with_fill * 1e3:.4e} env-steps/s")
    print(f"  eager host-lanes env: {eager_ms:.1f} ms for {E} episodes "
          f"(its table fills and uploads included) = "
          f"{S * B / eager_ms * 1e3:.4e} env-steps/s")
    print(f"  env against K1: max obs err {o_err:.3e} (tol {OBS_ATOL:g}), "
          f"max reward err / max|r| {rew_rel:.3e} (tol {REW_RTOL:g}), "
          f"lanes with divergent stock {stock_lanes}, finite {finite}")
    _gate("the host-lanes env disagrees with K1 on its tables",
          o_err <= OBS_ATOL and rew_rel <= REW_RTOL and stock_lanes == 0
          and finite)

    # (b) lanes against single envs seeded seed + lane, two episodes; row
    # s of the records is what the env returned after step s
    scale = float(k_rew.abs().max())
    lanes = torch.tensor(HOST_LANES, device=dev)
    first = env_obs[0][:, lanes].cpu().numpy()
    rec_obs = env_obs[1:2 * T + 1][:, :, lanes].cpu().numpy()
    rec_rew = env_rew[:2 * T][:, lanes].cpu().numpy()
    rec_stock = env_stock[..., lanes].cpu().numpy()       # [2T, N, P, lanes]
    a_host = act[:2 * T][:, :, lanes].cpu().numpy()
    worst = 0.0
    n_single = 0
    t0 = time.perf_counter()
    for i, b in enumerate(HOST_LANES):
        single = sct.SupplyChainNtoMEnv(seed=seed + b, dtype=torch.float32,
                                        device=dev)
        for ep in range(2):
            o = single.reset()
            want = first[:, i] if ep == 0 else rec_obs[T - 1, :, i]
            worst = max(worst, float(np.abs(o - want).max()))
            for t in range(T):
                s = ep * T + t
                o, r, done, _ = single.step(a_host[s, :, i])
                n_single += 1
                _gate(f"lane {b} step {s}: reward {r} against "
                      f"{rec_rew[s, i]}",
                      abs(r - rec_rew[s, i]) <= REW_RTOL * scale)
                if t < T - 1:
                    worst = max(worst,
                                float(np.abs(o - rec_obs[s, :, i]).max()))
                    _gate(f"lane {b} step {s}: stock differs from the "
                          f"single env's", np.array_equal(
                              single.state.stock[..., 0].cpu().numpy(),
                              rec_stock[s, ..., i]))
            _gate(f"lane {b}: the single env's episode did not end", done)
    single_s = time.perf_counter() - t0
    print(f"phase 15 (b): lanes {list(HOST_LANES)} of (a)'s first two "
          f"episodes against SupplyChainNtoMEnv(seed=seed + lane) on the "
          f"card: stock bit-equal, max obs err {worst:.3e} (tol "
          f"{OBS_ATOL:g}); {n_single} single-env steps in {single_s:.2f} s "
          f"= {n_single / single_s:.1f} steps/s")
    _gate("a lane disagrees with its single env", worst <= OBS_ATOL)
    bound = _bound(4 * B * (S * (cc.obs_dim + 1) + cc.N * cc.P)
                   + 4 * S * B * (cc.R * cc.P + cc.K + cc.A), 0)
    return dict(ms=k_ms, plain_ms=eager_ms, err=max(o_err, r_err),
                bound=bound, fill_ms=fill_ms, rate=k_rate,
                rate_fill=S * B / with_fill * 1e3,
                eager_rate=S * B / eager_ms * 1e3,
                single_rate=n_single / single_s)


def _host_beergame(seed, dev):
    """Phase 15 (c): the beer game v2 on per-lane MT19937 streams, eager
    and through K3, and lane 0 against a single ``BeerGameEnv2``."""
    import numpy as np
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.envs.vector import VecBeerGameEnv
    from gym_supplychain_tpu_torch.ops import beergame_collect as bgc

    B, W, E, L = BG_HOST_ENVS, WEEKS, HOST_EPISODES, 4
    S = E * W
    ranges = dict(customer_demand=(0, 12), shipment_delays=(0, 4))
    vec = VecBeerGameEnv(batch_size=B, v2=True, seed=seed, rng_mode="host",
                         weeks=W, device=dev, **ranges)
    g = torch.Generator(device=dev).manual_seed(seed)
    act = torch.randint(0, 20, (S, L, B), generator=g, device=dev,
                        dtype=torch.int32)
    env_obs = torch.empty((S, L, B), dtype=torch.int32, device=dev)
    env_rew = torch.empty((S, B), dtype=torch.int32, device=dev)
    dem, dls = [], []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    first = vec.reset()
    for e in range(E):
        # this episode's tables, as the host streams drew them at its reset
        dem.append(vec.customer_demand)
        dls.append(vec.shipment_delays[1:])
        for w in range(W):
            o, r, _ = vec.step(act[e * W + w])
            env_obs[e * W + w] = o
            env_rew[e * W + w] = r
    torch.cuda.synchronize(dev)
    eager_ms = 1e3 * (time.perf_counter() - t0)
    dem = torch.cat(dem).contiguous()
    dls = torch.cat(dls).contiguous()
    run = bgc.make_beergame_collect(W, L, B, E, mode="actions", delay=None,
                                    max_delay=4, v2=True, max_stock=100,
                                    exceeded_capacity_penalty=100, device=dev)
    k_ms, (k_obs, k_rew) = _timed(lambda: run(dem, dls, act), REPS)
    # the env's last week of an episode shows the next episode's first obs
    inner = torch.arange(S, device=dev) % W != W - 1
    exact = (torch.equal(k_rew, env_rew)
             and torch.equal(k_obs[inner], env_obs[inner]))
    err = float(max((k_rew - env_rew).abs().max(),
                    (k_obs[inner] - env_obs[inner]).abs().max()))
    single = sct.BeerGameEnv2(seed=seed, device=dev, **ranges)
    h_obs, h_rew = env_obs[:, :, 0].cpu().numpy(), env_rew[:, 0].cpu().numpy()
    first = first[:, 0].cpu().numpy()
    lane0 = True
    for e in range(E):
        o = single.reset()
        lane0 &= np.array_equal(o, first if e == 0 else h_obs[e * W - 1])
        for w in range(W):
            o, r, done, _ = single.step(act[e * W + w, :, 0].cpu().numpy())
            lane0 &= r == h_rew[e * W + w]
            if w < W - 1:
                lane0 &= np.array_equal(o, h_obs[e * W + w])
        lane0 &= done
    print(f"phase 15 (c): beergame-v2, demand [0, 12), delays [0, 4), {B} "
          f"MT19937 lanes (seed + lane), {W} weeks, {E} episodes: eager "
          f"host env {eager_ms:.1f} ms (table draws included) = "
          f"{S * B / eager_ms * 1e3:.4e} env-steps/s; K3 on its tables "
          f"{k_ms:.4f} ms (median of {REPS}) = {S * B / k_ms * 1e3:.4e} "
          f"env-steps/s; bit-exact {exact} (max err {err:g}); lane 0 equal "
          f"to BeerGameEnv2(seed=seed) {bool(lane0)}")
    _gate("the beer game's host env disagrees with K3 or with a single env",
          exact and lane0)
    # demand, delays, actions in; obs and reward out, int32
    bound = _bound(4 * S * B * (3 + 2 * L), 0)
    return dict(ms=k_ms, plain_ms=eager_ms, err=err, bound=bound,
                eager_rate=S * B / eager_ms * 1e3, rate=S * B / k_ms * 1e3)


def _recorded_on_card(dev):
    """Phase 15 (d): the committed reference recordings through the port's
    strict-obs single envs on the card, at the recorded tolerances."""
    import numpy as np
    import gym_supplychain_tpu_torch as sct

    data = ROOT / "tests" / "data"
    sc = np.load(data / "ref_trajectories.npz")
    steps, worst_obs = 0, 0.0
    t0 = time.perf_counter()
    for name, (seed, cls, kw) in _RECORDED_SC.items():
        env = getattr(sct, cls)(strict_obs=True, device=dev, **kw)
        env.seed(seed)
        for ep in range(2):
            acts = sc[f"{name}/ep{ep}/actions"]
            ref_obs = sc[f"{name}/ep{ep}/obs"]
            ref_rew = sc[f"{name}/ep{ep}/rewards"]
            worst_obs = max(worst_obs, float(np.abs(env.reset()
                                                    - ref_obs[0]).max()))
            for t in range(acts.shape[0]):
                obs, r, done, _ = env.step(acts[t])
                steps += 1
                worst_obs = max(worst_obs,
                                float(np.abs(obs - ref_obs[t + 1]).max()))
                _gate(f"{name} ep{ep} t={t + 1}: reward {r} against the "
                      f"recorded {ref_rew[t]}", np.allclose(
                          r, ref_rew[t], rtol=REF_REW_RTOL,
                          atol=REF_REW_ATOL))
            _gate(f"{name} ep{ep}: the episode did not end", done)
    single_s = time.perf_counter() - t0
    _gate(f"recorded observations off by {worst_obs:.3e}",
          worst_obs <= REF_OBS_ATOL)
    bg = np.load(data / "ref_beergame.npz")
    weeks = 0
    for name, (cls, args, kw, episodes) in _recorded_beergame().items():
        env = getattr(sct, cls)(*args, device=dev, **kw)
        for ep, acts in enumerate(episodes):
            key = f"{name}/ep{ep}"
            _gate(f"{key} reset obs", np.array_equal(env.reset(),
                                                     bg[f"{key}/obs"][0]))
            for w in range(acts.shape[0]):
                obs, r, _, _ = env.step(acts[w])
                weeks += 1
                _gate(f"{key} week {w + 1}", np.array_equal(
                    obs, bg[f"{key}/obs"][w + 1])
                    and r == bg[f"{key}/rewards"][w])
            _gate(f"{key} final state", np.array_equal(
                env.inventory, bg[f"{key}/inventory"]) and np.array_equal(
                env.backlog, bg[f"{key}/backlog"]))
    print(f"phase 15 (d): the recorded reference on the card: "
          f"{', '.join(_RECORDED_SC)} through the strict-obs single envs "
          f"(2 episodes each, {steps} steps): max obs err {worst_obs:.3e} "
          f"(tol {REF_OBS_ATOL:g}), rewards within rtol {REF_REW_RTOL:g} "
          f"atol {REF_REW_ATOL:g}; {steps / single_s:.1f} single-env "
          f"steps/s; the beer game's {len(_recorded_beergame())} scenarios "
          f"({weeks} weeks) exact")


def phase_host_streams(B, seed, dev="cuda"):
    """Phase 15: the host-parity MT19937 streams on the card."""
    import torch
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

    dev = torch.device(dev)
    t0 = time.perf_counter()
    reset_counters()
    sc = _host_lanes(B, seed, dev)
    bg = _host_beergame(seed, dev)
    _recorded_on_card(dev)
    sc["launches"] = _launches("supplychain_collect")
    bg["launches"] = _launches("beergame_collect")
    print(f"  launch counts of phase 15: supplychain_collect "
          f"{sc['launches']}, beergame_collect {bg['launches']}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    _gate("K1 or K3 was not launched",
          sc["launches"] > 0 and bg["launches"] > 0)
    return dict(sc=sc, bg=bg)


def _bf16_net(env_id, hidden, seed, dev, M=TRAIN_T * ENVS, tag="(a)"):
    """Phases 16 (a), 17: K2's bf16 mode on one net against its plain bf16
    version at phase 14's gates, on phase 7's kind of inputs at M samples
    (the trainer's by default); timed.  Returns the net's row."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig
    from gym_supplychain_tpu_torch.ops import ppo_update as pu
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout

    bf16 = torch.bfloat16
    cc = sct.make_chain(env_id, total_time_steps=TRAIN_T)
    O, A = cc.obs_dim, cc.A
    lay = MlpLayout(O, A, hidden)
    plan = pu.ppo_update_bf16_plan(lay)
    model = ActorCritic(MLPConfig(O, A, hidden),
                        torch.Generator().manual_seed(seed), dev)
    data = _update_data(cc, model, M, seed, dev)
    gf = pu.make_ppo_update_grads(O, A, hidden, M, compute_dtype=bf16)
    lk, gk = gf(model, *data)
    lk2, gk2 = gf(model, *data)
    lp, gp = pu.ppo_update_plain(model, *data, compute_dtype=bf16)
    torch.cuda.synchronize()
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    per = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(gk, gp))
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    cos = _flat_cos(gk, gp)
    same = torch.equal(lk, lk2) and all(torch.equal(a, b)
                                        for a, b in zip(gk, gk2))
    card = statistics.median(_back_to_back(lambda: gf(model, *data),
                                           BACK_TO_BACK)[0] for _ in range(3))
    plain_ms, _ = _timed(lambda: pu.ppo_update_plain(
        model, *data, compute_dtype=bf16), 2)
    macs = 3 * _macs(lay, [0, 1]) - O * 2 * hidden[0]
    bound = _bound(4 * (M * (O + A + 3) + 2 * lay.n_params), 2 * macs * M,
                   PEAK_BF16)
    name = (f"wgmma <{plan['H']},{plan['layers']},{plan['KP']},{plan['HA']}>"
            if plan["kernel"] == "wgmma" else "mma.sync")
    ok = rel <= 1e-3 and per <= 1e-2 and cos >= 0.9999 and same
    print(f"  {tag} {env_id} (O {O}, A {A}), hidden {hidden}, M={M}: {name}; "
          f"loss {float(lk):.8f} / plain {float(lp):.8f} ({rel:.3e} "
          f"relative, tol 1e-3); largest tensor error / its max {per:.3e} "
          f"(tol 1e-2); flat cosine {cos:.8f} (>= 0.9999); two launches "
          f"bit-identical {same}; {card:.4f} ms a call on the card "
          f"({BACK_TO_BACK} back to back, median of 3), plain bf16 autograd "
          f"{plain_ms:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{2 * macs * M / 1e9:.2f} GFLOP at 989 TFLOP/s bf16)")
    if not ok:
        raise RuntimeError(f"ppo_update bf16 {name} on {env_id} {hidden}: "
                           "kernel disagrees with its plain version or does "
                           "not repeat")
    return dict(env=env_id, hidden=hidden, kernel=plan["kernel"], err=err,
                ms=card, plain_ms=plain_ms, bound=bound)


def phase_multihost(seed):
    """Phase 16: (a) K2's bf16 mode on every net of ``RESTORED_NETS``,
    then the train CLI with the bf16 learner on two of them; (b) the
    data-parallel trainer at BASELINE.json's ntom 8192 envs on 2 ranks of
    4096 sharing the card over gloo, against 1 process at 8192
    (``benchmarks/multihost_scaling.py``); (c) one traced ``ppo-ntom-fused``
    iteration and the card's busy share of it."""
    import tempfile

    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.benchmarks import multihost_scaling
    from gym_supplychain_tpu_torch.learn import ppo, train
    from gym_supplychain_tpu_torch.utils.profiling import (kernel_busy_share,
                                                           reset_counters,
                                                           trace)

    dev = torch.device("cuda")
    print("phase 16: the nets K2's bf16 mode takes again; data-parallel "
          "training over processes; a traced iteration")
    nets = [_bf16_net(env_id, hidden, seed, dev)
            for env_id, hidden in RESTORED_NETS]
    # the user's path: the train CLI with the bf16 learner on the restored
    # mma.sync kernel's net and on the new wgmma instance's
    kernels = ("supplychain_policy", "ppo_update_bf16", "ppo_update_bf16_mma")
    reset_counters()
    for hidden in ((64, 128), (64, 64, 64)):
        _, m = train.main(["--env", "sc-2perstage-multiproduct-v0", "--envs",
                           str(ENVS), "--horizon", str(TRAIN_T), "--hidden",
                           *map(str, hidden), "--learner-dtype", "bf16",
                           "--iters", "2", "--log-every", "1", "--seed",
                           str(seed)])
        if not math.isfinite(float(m["loss"])):
            raise RuntimeError(f"train CLI bf16 {hidden}: loss not finite")
    counts = {k: _launches(k) for k in kernels}
    print(f"  (a) launch counts of the two CLI runs: {counts}")
    if min(counts.values()) < 1:
        raise RuntimeError("phase 16 (a): a kernel of the bf16 path was not "
                           "launched")

    # (b) 1 process at 8192, then 2 ranks of 4096 on cuda:0 over gloo
    smi = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    r1, r2 = multihost_scaling.run(((1, 1), (2, 1)), envs=MULTI_ENVS,
                                   horizon=TRAIN_T, hidden=HIDDEN, epochs=2,
                                   iters=MULTI_ITERS, seed=seed,
                                   device="cuda")
    diffs = {k: abs(r2["first"][k] - r1["first"][k])
             / max(1.0, abs(r1["first"][k])) for k in r1["first"]}
    print(f"  (b) supplychain-ntom-v0, {MULTI_ENVS} global envs, hidden "
          f"{HIDDEN}, T={TRAIN_T}, epochs 2, 1 minibatch: 1 process against "
          f"2 ranks of {MULTI_ENVS // 2} on one card over {r2['backend']}")
    print(f"  (b) first iteration, 1 process {r1['first']}, 2 ranks "
          f"{r2['first']}; |diff| / max(1, |v|) {diffs} (tol {MULTI_TOL:g}); "
          f"parameters bit-equal on the ranks {r2['replicated']}; the 2-rank "
          f"checkpoint resumes bit for bit {r2['resume_bit_exact']} (1 "
          f"process: {r1['resume_bit_exact']}); launches over the ranks "
          f"{r2['launches']}")
    print(f"  (b) {smi}: global train env-steps/s, 1 process "
          f"{r1['train_env_steps_per_s']:.1f} ({r1['iter_ms']:.3f} ms an "
          f"iteration); 2 processes sharing one card "
          f"{r2['train_env_steps_per_s']:.1f} ({r2['iter_ms']:.3f} ms; one "
          f"card time-shared by two processes, not a scaling figure); "
          f"all-reduce {r2['allreduce_ms_per_call']:.4f} ms a call x "
          f"{r2['allreduce_calls_per_iter']:g} calls = "
          f"{r2['allreduce_ms_per_iter']:.4f} ms an iteration")
    if not (max(diffs.values()) <= MULTI_TOL and r2["replicated"]
            and r2["resume_bit_exact"] and r1["resume_bit_exact"]
            and min(r2["launches"].values()) >= 1):
        raise RuntimeError("phase 16 (b): the 2-rank run disagrees with 1 "
                           "process, the ranks differ, the resume is not "
                           "exact or a kernel was not launched")

    # (c) one traced iteration of ppo-ntom-fused (after a warm one)
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=TRAIN_T)
    cfg = ppo.PPOConfig(epochs=2, hidden=HIDDEN, fused_update=True)
    init_fn, step = ppo.make_ppo_fused(cc, ENVS, cfg, device=dev)
    state, _ = step(init_fn(seed))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            state, m = step(state)
            torch.cuda.synchronize()
        busy = kernel_busy_share(f"{tmp}/trace.rank0.json")
    print(f"  (c) one traced ppo-ntom-fused iteration (B={ENVS}): "
          f"{busy['kernels']} kernel events, the card busy "
          f"{busy['busy_ms']:.3f} ms of a {busy['window_ms']:.3f} ms window: "
          f"busy share {busy['share']:.4f}, idle {1 - busy['share']:.4f}")
    return dict(nets=nets, bf16_counts=counts, r1=r1, r2=r2, busy=busy)


def phase_tensor_parallel(seed):
    """Phase 17: the mesh's model axis.  ``benchmarks/multihost_scaling.py``
    runs the scan trainer (autograd, K2 and K2 bf16 on the gathered net),
    the fused trainer (its parameters whole) and the beer game's trainer
    at 4096 global envs on 1 process and on a ``1x2`` mesh, and the beer game on ``2x1`` (two ranks sharing
    ``cuda:0`` over gloo); the first iterations against 1 process, the
    ranks' leaves, the tables and the checkpoints' moves are gated.  Then
    K2 and K2 bf16 at the path's shape (M = 16 x 4096 on the gathered net,
    the trainers' initial weights) against their plain versions, timed."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.benchmarks import multihost_scaling
    from gym_supplychain_tpu_torch.learn.ppo import PPOConfig
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig

    dev = torch.device("cuda")
    smi = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    rollout = PPOConfig().rollout_steps
    kw = dict(envs=ENVS, horizon=TP_HORIZON, hidden=HIDDEN, epochs=2,
              iters=TP_ITERS, seed=seed, device="cuda")
    print(f"phase 17: tensor parallelism (the mesh's model axis), "
          f"{ENVS} global envs, hidden {HIDDEN}, rollout {rollout}, "
          f"epochs 2, 1 minibatch, {1 + TP_ITERS} iterations a run; 2 ranks "
          f"share cuda:0 over gloo")
    one, tp = multihost_scaling.run(((1, 1), (1, 2)),
                                    cases=TP_CASES, **kw)
    dp, = multihost_scaling.run(((2, 1),), cases=("beergame",), **kw)
    failed = []

    def gate(what, ok):
        if not ok:
            failed.append(what)

    def rel(run, ref):
        return {k: abs(run["first"][k] - ref["first"][k])
                / max(1.0, abs(ref["first"][k])) for k in ref["first"]}

    rows = [("(a)", "1x2", case, tp, one)
            for case in TP_SCAN + ("fused",)] + [
        ("(b)", "2x1", "beergame", dp, one), ("(b)", "1x2", "beergame", tp,
                                              one)]
    for tag, shape, case, run, ref in rows:
        r, o = run["cases"][case], ref["cases"][case]
        d = rel(r, o)
        extra = (f"; tables are the global draw's lanes {r['tables_global']}"
                 if case == "beergame" else "")
        print(f"  {tag} {case} on {shape}: first iteration {r['first']}, 1 "
              f"process {o['first']}; |diff| / max(1, |v|) max "
              f"{max(d.values()):.3e} (tol {MULTI_TOL:g}); replicated "
              f"leaves bit-equal {r['replicated']}, gathered net equal "
              f"{r['gathered_equal']}{extra}; launches over the ranks "
              f"{r['launches']}, fewest on a rank {r['launches_min']}")
        print(f"  {tag} {smi}: {case} {r['iter_ms']:.3f} ms an iteration on "
              f"{shape} ({r['train_env_steps_per_s']:.1f} global train "
              f"env-steps/s), 1 process {o['iter_ms']:.3f} ms "
              f"({o['train_env_steps_per_s']:.1f}); data group: "
              f"{r['allreduce_calls_per_iter']:g} all-reduces an iteration, "
              f"{r['allreduce_ms_per_call']:.4f} ms a call; model group: "
              f"{r['model_calls_per_iter']:g} collectives an iteration, "
              f"gather {r['model_gather_ms']:.4f} ms and reduce-scatter "
              f"{r['model_reduce_scatter_ms']:.4f} ms a call at the update's "
              f"shape, gather {r['model_gather_rollout_ms']:.4f} ms at the "
              f"rollout's (two processes time-sharing one card: no scaling "
              f"figure)")
        gate(f"{case} on {shape}: first iteration",
             max(d.values()) <= MULTI_TOL)
        gate(f"{case} on {shape}: replicated", r["replicated"]
             and r["gathered_equal"] and r["resume_bit_exact"])
        if case == "beergame":
            gate(f"beergame on {shape}: tables", r["tables_global"])
    for case in TP_CASES:
        r = tp["cases"][case]
        print(f"  (c) {case}: a 1x2 checkpoint resumes bit for bit "
              f"{r['resume_bit_exact']}; restored into 1 process it is the "
              f"gathered net bit for bit {r['to_one_bit_exact']}; a "
              f"1-process file restored into 1x2 gives each rank its rows "
              f"{r['from_one_rows']}")
        gate(f"{case}: checkpoints", r["resume_bit_exact"]
             and r["to_one_bit_exact"] and r["from_one_rows"])
    k2 = tp["cases"]["scan-k2"]
    bf = tp["cases"]["scan-k2-bf16"]
    gate("K2 launched on every rank", k2["launches_min"]["ppo_update"] >= 1)
    gate("K2 bf16 launched on every rank",
         sum(bf["launches_min"].values()) >= 1)
    gate("K1 policy and K2 of the fused trainer launched on every rank",
         min(tp["cases"]["fused"]["launches_min"].values()) >= 1)

    # K2 and K2 bf16 at the path's shape on the gathered net
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=TP_HORIZON)
    M = rollout * ENVS
    net = ActorCritic(MLPConfig(cc.obs_dim, cc.A, HIDDEN),
                      torch.Generator().manual_seed(seed), dev)
    f32 = _f32_update(cc, net, M, HIDDEN, seed)
    print(f"  K2 at M={M} on the gathered net: max abs err kernel "
          f"{f32['err_k']:.3e}, plain float32 {f32['err_p']:.3e} against "
          f"float64 (gate {4 * f32['err_p'] + 1e-7 * f32['scale']:.3e}); "
          f"two launches bit-identical {f32['same']}; {f32['card_ms']:.4f} "
          f"ms a call on the card ({BACK_TO_BACK} back to back), plain "
          f"autograd {f32['plain_ms']:.3f} ms")
    gate("K2 at the path's shape", f32["ok"])
    b16 = _bf16_net("supplychain-ntom-v0", HIDDEN, seed, dev, M=M,
                    tag="K2 bf16 at the path's shape:")
    if failed:
        raise RuntimeError(f"phase 17: {'; '.join(failed)}")
    return dict(one=one, tp=tp, dp=dp, f32=f32, bf16=b16, M=M)


def _learn_bar():
    """Phase 18's bar: its compare-CLI flags, parsed, and its entry of
    ``learn/bars.py``."""
    from gym_supplychain_tpu_torch.learn import bars

    return bars.parse(LEARN_BAR), bars.BARS[LEARN_BAR]


def _learn_kernels(seed):
    """Phase 18's kernels at its shapes (the bar's env, B = 256, T = 60,
    hidden (64, 64), mu.w x100) against their plain versions, timed: K1
    ``policy`` sample-major, K2 and K2 bf16 at M = T x B, K4 on random
    tables.  Returns each one's row."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.ops import supplychain_collect as scc
    from gym_supplychain_tpu_torch.ops import supplychain_episode as sce
    from gym_supplychain_tpu_torch.ops._mlp import MlpLayout
    from gym_supplychain_tpu_torch.ops.supplychain_dense import (
        dense_descriptor)

    dev = torch.device("cuda")
    bar, _ = _learn_bar()
    B, T, H = bar.envs, bar.horizon, tuple(bar.hidden)
    cc = sct.make_chain(bar.env, total_time_steps=T)
    O, A, M = cc.obs_dim, cc.A, T * B
    model = _policy_model(cc, seed, dev, H)
    lay = MlpLayout(O, A, H)
    desc = torch.as_tensor(dense_descriptor(cc), device=dev)
    ints = torch.as_tensor(lay.ints, device=dev)
    rows, errs = {}, []

    def k1():
        return scc.launch_supplychain_policy(desc, cc, lay, ints,
                                             lay.pack(model.flat()), T, B,
                                             "policy", seed=seed,
                                             sample_major=True)

    def k1_plain():
        return scc.supplychain_collect_plain(cc, 1, B, "policy", seed=seed,
                                             params=model, sample_major=True,
                                             device=dev)

    tag = f"{bar.env} B={B} T={T} hidden {H}"
    _check_policy(f"K1 policy, {tag}, kernel vs plain", k1(), k1_plain(),
                  errs)
    ms, _ = _timed(k1, REPS)
    plain_ms, _ = _timed(k1_plain, PLAIN_REPS)
    rows["k1"] = dict(err=errs[-1], ms=ms, plain_ms=plain_ms, bound=_bound(
        4 * (sum(lay.wsec) + M * (O + A + 3) + cc.N * cc.P * B),
        2 * _macs(lay, [0, 1]) * M))

    dem, lt, _ = _episode_tables(cc, B, seed, dev)
    pack = lay.pack(model.flat())

    def k4():
        return sce.launch_supplychain_greedy(desc, cc, lay, ints, pack, B,
                                             dem, lt)

    def k4_plain():
        return sce.supplychain_episode_plain(cc, B, "policy", dem, lt,
                                             params=model)

    _check_episode(f"K4, {tag}, greedy kernel vs plain", k4(), k4_plain(),
                   errs)
    ms, _ = _timed(k4, REPS)
    plain_ms, _ = _timed(k4_plain, PLAIN_REPS)
    tables = 4 * (dem.numel() + (lt.numel() if lt is not None else 0))
    rows["k4"] = dict(err=errs[-1], ms=ms, plain_ms=plain_ms, bound=_bound(
        tables + 4 * (T * B + cc.N * cc.P * B) + 4 * lay.wsec[0],
        2 * _macs(lay, [0]) * T * B))

    f32 = _f32_update(cc, model, M, H, seed)
    print(f"  K2 at M={M}, {tag}: max abs err kernel {f32['err_k']:.3e}, "
          f"plain float32 {f32['err_p']:.3e} against float64 (gate "
          f"{4 * f32['err_p'] + 1e-7 * f32['scale']:.3e}); two launches "
          f"bit-identical {f32['same']}; {f32['card_ms']:.4f} ms a call on "
          f"the card ({BACK_TO_BACK} back to back), plain autograd "
          f"{f32['plain_ms']:.3f} ms")
    if not f32["ok"]:
        raise RuntimeError("phase 18: K2 disagrees with float64 autograd")
    macs = 3 * _macs(lay, [0, 1]) - O * 2 * H[0]
    rows["k2"] = dict(err=f32["err_k"], ms=f32["card_ms"],
                      plain_ms=f32["plain_ms"], bound=_bound(
                          4 * (M * (O + A + 3) + 2 * lay.n_params),
                          2 * macs * M))
    rows["k2_bf16"] = _bf16_net(bar.env, H, seed, dev, M=M,
                                tag="K2 bf16 at phase 18's shape:")
    return rows


def _learn_parity(seed):
    """The fused engine with the kernels (K1 ``policy``, K2) against the
    same trainer on their plain versions (``plain=True``: plain collection,
    autograd), ``LEARN_PARITY_ITERS`` iterations from one seed at phase 18's
    shape: after each, the cumulative parameter change's cosine (>= 0.999)
    and the mean reward and loss (within 1e-4 relative).  A weight pack a
    version behind Adam, a ``log_std`` that does not reach the sampler or a
    clip that parts from autograd's shows from the second iteration on.
    The bf16 learner's cosine against the float32 kernel trainer is
    printed beside it."""
    import torch
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.learn import ppo

    bar, _ = _learn_bar()
    cc = sct.make_chain(bar.env, total_time_steps=bar.horizon)
    cfg = ppo.PPOConfig(hidden=tuple(bar.hidden), lr=bar.lr,
                        epochs=bar.epochs, fused_update=True)
    runs = {}
    for name, plain, dtype in (("kernel", False, None), ("plain", True, None),
                               ("kernel bf16", False, torch.bfloat16)):
        init_fn, step = ppo.make_ppo_fused(
            cc, bar.envs, cfg._replace(learner_dtype=dtype), device="cuda",
            plain=plain)
        state = init_fn(seed)
        p0 = torch.cat([x.detach().reshape(-1) for x in state.params.flat()])
        rows = []
        for _ in range(LEARN_PARITY_ITERS):
            state, m = step(state)
            rows.append(([torch.cat([x.detach().reshape(-1) for x in
                                     state.params.flat()]) - p0],
                         float(m["mean_reward"]), float(m["loss"])))
        runs[name] = rows
    ok = True
    for it, (k, p, b) in enumerate(zip(runs["kernel"], runs["plain"],
                                       runs["kernel bf16"])):
        cos = _flat_cos(k[0], p[0])
        rew = abs(k[1] - p[1]) / abs(p[1])
        loss = abs(k[2] - p[2]) / abs(p[2])
        print(f"  iteration {it + 1}: kernels against plain: cosine of the "
              f"parameter change {cos:.8f} (>= 0.999), mean reward "
              f"{rew:.3e} and loss {loss:.3e} relative (tol 1e-4); bf16 "
              f"learner against float32: cosine {_flat_cos(b[0], k[0]):.6f}")
        ok = ok and cos >= 0.999 and rew <= 1e-4 and loss <= 1e-4
    return ok


def phase_learning(seed):
    """Phase 18: learning on the card.  The sc-2perstage bar of the JAX
    package (T = 60, 256 envs, hidden (64, 64), lr 3e-3, 4 epochs, 220
    iterations, greedy evaluation on key seed + 1 beside the base-stock
    grid on key seed) through ``learn.compare_baseline`` (``learn/bars.py``
    gives the flags) on the scan trainer, the fused engine (K1 ``policy`` + K2) and the bf16 learner
    (K1 ``policy`` + K2 bf16), launch counts zeroed before each run; the
    fused engine's kernels against plain over 5 iterations
    (``_learn_parity``); then the four kernels at the phase's shapes
    against their plain versions (``_learn_kernels``).  Returns each run's
    launches and the kernels' rows."""
    import torch
    from gym_supplychain_tpu_torch.learn import bars
    from gym_supplychain_tpu_torch.utils.profiling import reset_counters

    smi = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    bar, spec = _learn_bar()
    print(f"phase 18: learning on the card, {bar.env}, T={bar.horizon}, "
          f"{bar.envs} envs, hidden {tuple(bar.hidden)}, lr {bar.lr:g}, "
          f"{bar.epochs} epochs, {bar.iters} iterations, seed {seed}")
    kernels = {"K1 policy": "supplychain_policy", "K2": "ppo_update",
               "K2 bf16": "ppo_update_bf16",
               "K2 bf16 mma.sync": "ppo_update_bf16_mma",
               "K4": "supplychain_greedy"}
    runs, failed = {}, []
    t_phase = time.perf_counter()
    for name, engine, dtype in LEARN_ENGINES:
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # its JSON report
            rep = bars.run(LEARN_BAR, "--seed", str(seed), "--engine",
                           engine, *(["--learner-dtype", dtype] if dtype
                                     else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: _launches(n) for k, n in kernels.items()}
        ppo_r, bs = rep["ppo"], rep["base_stock"]
        z2, tuned = bs["grid"][str(spec.z)], bs["mean_return"]
        trained = ppo_r["greedy_mean_return"]
        m2, mt = bars.margin(rep, spec.z), bars.margin(rep)
        curve = [(c["iter"], c["greedy_mean_return"]) for c in ppo_r["curve"]]
        print(f"  {name}: greedy return every {bar.iters // 10} iterations "
              f"{curve}")
        print(f"  {name} {smi}: trained {trained:.1f}; base stock "
              f"z={spec.z} {z2:.1f}, tuned (z={bs['best_z']}) {tuned:.1f}; "
              f"margin over z={spec.z} {m2:.2%}, over the tuned {mt:.2%} "
              f"(the JAX bar: {spec.margin:.0%} over z={spec.z}; a miss is "
              f"a draw first, the parity below the fault detector); train "
              f"{ppo_r['train_seconds']} s, the run "
              f"{wall:.1f} s with the grid and evaluations (host clock); "
              f"launches {launches}")
        ok = all(math.isfinite(v) for _, v in curve) and math.isfinite(
            trained)
        if engine == "scan":
            ok = ok and bars.passes(LEARN_BAR, rep)
        else:
            rel = ppo_r["kernel_vs_scan_relative"]
            update = (launches["K2"] if dtype is None
                      else launches["K2 bf16"] + launches["K2 bf16 mma.sync"])
            print(f"  {name}: the greedy rollout kernel (K4) "
                  f"{ppo_r['kernel_greedy_mean_return']:.1f} against the scan"
                  f" evaluator, {rel:.3e} relative (tol {EVAL_RTOL:g})")
            ok = (ok and mt > 0 and rel <= EVAL_RTOL and launches["K4"] >= 1
                  and launches["K1 policy"] == bar.iters
                  and update == bar.epochs * bar.iters)
        if not ok:
            failed.append(name)
        runs[name] = launches
    print(f"  the fused engine, kernels against plain over "
          f"{LEARN_PARITY_ITERS} iterations:")
    if not _learn_parity(seed):
        failed.append("kernels against plain")
    kernels = _learn_kernels(seed)
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s (host clock)")
    if failed:
        raise RuntimeError(f"phase 18: learning bar missed by {failed}")
    return dict(runs=runs, kernels=kernels, env=bar.env)


def _kernel_lines(res, tr, upd, ep, ev, dn, bge, dm, bf, hs, mh, tp, ln,
                  sc_errs, bg_errs, pol_errs, pu_errs, ep_errs, dm_errs):
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
    # its bf16 mode: the same work, its operations on the tensor cores
    line("ppo_update[bf16]", "ppo_update_bf16.cuh",
         "gym_supplychain_tpu/ops/ppo_update_pallas.py:91",
         bf["counts"]["ppo_update_bf16"], bf["upd"]["err"], bf["upd"]["ms"],
         bf["upd"]["plain_ms"], bf["upd"]["bound"])
    for mode in ("seeded", "actions", "policy"):
        r = ep[mode]
        line(f"supplychain_episode[{mode}]",
             "supplychain_policy.cu" if mode == "policy"
             else "supplychain_episode.cu",
             f"{sc_pallas}:736",
             ev["launches"] if mode == "policy" else r["launches"],
             max(ep_errs), r["ms"], r["plain_ms"], r["bound"])
    # phase 10: the evaluator's table draw, a kernel of the port alone
    r = ev["draw_kernel"]
    line("episode_tables[supplychain-ntom-v0]", "episode_tables.cu",
         "none: port-only, the JAX package draws its tables with jax.random",
         r["launches"], r["err"], ev["tables_ms"], ev["tables_plain_ms"],
         r["bound"])
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
    # phase 15: K1 `actions` and K3 on the host MT19937 tables; the plain
    # time is the eager host env's over the same episodes
    r = hs["sc"]
    line("supplychain_collect[host-lanes supplychain-ntom-v0]",
         "supplychain_lanes.cu", f"{sc_pallas}:791", r["launches"], r["err"],
         r["ms"], r["plain_ms"], r["bound"])
    r = hs["bg"]
    line("beergame_collect[host beergame-v2]", "beergame_collect.cu",
         "gym_supplychain_tpu/ops/beergame_pallas.py:149", r["launches"],
         r["err"], r["ms"], r["plain_ms"], r["bound"])
    # phase 16: the bf16 mode's mma.sync kernel (its first net's time and
    # bound, the largest error over its nets), launched by the train CLI
    mma = [n for n in mh["nets"] if n["kernel"] == "mma"]
    n = mma[0]
    line(f"ppo_update[bf16 mma.sync, {n['env']} {list(n['hidden'])}]",
         "ppo_update_bf16_mma.cu",
         "gym_supplychain_tpu/ops/ppo_update_pallas.py:91",
         mh["bf16_counts"]["ppo_update_bf16_mma"],
         max(x["err"] for x in mma), n["ms"], n["plain_ms"], n["bound"])
    # phase 16 (b): K1 `policy` and K2 on each of 2 ranks of 4096 lanes
    # (phases 6-8's shape and times); launches summed over the ranks
    r2 = mh["r2"]["launches"]
    for name, source, replaces, key, err, ms, plain_ms, base in (
            ("supplychain_collect[policy, 2 ranks]", "supplychain_policy.cu",
             f"{sc_pallas}:791", "supplychain_collect[policy]",
             max(pol_errs), tr["k1"]["ms"], tr["k1"]["plain_ms"],
             lines[len(res)]),
            ("ppo_update[2 ranks]", "ppo_update.cu",
             "gym_supplychain_tpu/ops/ppo_update_pallas.py:91", "ppo_update",
             max(pu_errs), upd["ms"], upd["plain_ms"], lines[len(res) + 1])):
        line(name, source, replaces, r2[key], err, ms, plain_ms,
             (base["bound_ms"], base["bound_by"]))
    # phase 17: K2 and K2 bf16 on the net gathered over the model axis of
    # the 1x2 scan trainer (M = 16 x 4096 a rank); launches over the ranks
    M = tp["M"]
    f32 = tp["f32"]
    line("ppo_update[tensor-parallel 1x2, gathered net]", "ppo_update.cu",
         "gym_supplychain_tpu/ops/ppo_update_pallas.py:91",
         tp["tp"]["cases"]["scan-k2"]["launches"]["ppo_update"],
         f32["err_k"], f32["card_ms"], f32["plain_ms"],
         _bound(4 * (M * (cc.obs_dim + cc.A + 3) + 2 * lay.n_params),
                2 * macs * M))
    b = tp["bf16"]
    line("ppo_update[bf16, tensor-parallel 1x2, gathered net]",
         "ppo_update_bf16.cuh",
         "gym_supplychain_tpu/ops/ppo_update_pallas.py:91",
         sum(tp["tp"]["cases"]["scan-k2-bf16"]["launches"].values()),
         b["err"], b["ms"], b["plain_ms"], b["bound"])
    # phase 18: the four kernels of the learning runs at their shapes;
    # launches summed over the three engines' runs
    k, runs = ln["kernels"], ln["runs"].values()
    tag = f"learning {ln['env']}"
    for name, source, replaces, key, row in (
            (f"supplychain_collect[policy, {tag}]", "supplychain_policy.cu",
             f"{sc_pallas}:791", ("K1 policy",), k["k1"]),
            (f"ppo_update[{tag}]", "ppo_update.cu",
             "gym_supplychain_tpu/ops/ppo_update_pallas.py:91", ("K2",),
             k["k2"]),
            (f"ppo_update[bf16, {tag}]",
             "ppo_update_bf16.cuh" if k["k2_bf16"]["kernel"] == "wgmma"
             else "ppo_update_bf16_mma.cu",
             "gym_supplychain_tpu/ops/ppo_update_pallas.py:91",
             ("K2 bf16", "K2 bf16 mma.sync"), k["k2_bf16"]),
            (f"supplychain_episode[policy, {tag}]", "supplychain_policy.cu",
             f"{sc_pallas}:736", ("K4",), k["k4"])):
        line(name, source, replaces,
             sum(r[c] for r in runs for c in key), row["err"],
             row["ms"], row["plain_ms"], row["bound"])
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
    for kernel in ("ppo_grad_kernel", "ppo_grad_bf16_kernel",
                   "ppo_grad_bf16_mma_kernel", "sc_lane_kernel",
                   "sc_policy_lane_kernel", "bg_collect_kernel"):
        rows = _build.ptxas_report(kernel)
        if not rows:
            raise RuntimeError(f"no ptxas report for {kernel}")
        for r in rows:
            print(f"  ptxas {r['function']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, spill loads "
                  f"{r['spill_loads']} B, stack {r['stack']} B a thread")
            # the bf16 K2s spill nothing; the wgmma kernel's budget holds
            # everything in registers (the mma.sync kernel indexes its
            # layers' tile pointers from a stack frame)
            if kernel.startswith("ppo_grad_bf16") and (
                    r["spill_stores"] or r["spill_loads"]
                    or (r["stack"] and kernel == "ppo_grad_bf16_kernel")):
                raise RuntimeError(f"{r['function']} spills or uses a stack")

    B = ENVS
    chains = {env_id: sct.make_chain(env_id)
              for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0")}
    sc_errs, bg_errs, pol_errs, pu_errs, ep_errs = [], [], [], [], []
    dm_errs, seconds = [], {1: round(time.perf_counter() - t0, 1)}

    def timed(n, phase, *a):
        """Run phase ``n`` and keep its seconds on the host clock."""
        t = time.perf_counter()
        out = phase(*a)
        seconds[n] = round(time.perf_counter() - t, 1)
        return out

    seed = args.seed
    timed(2, phase_supplychain, chains, B, CHECK_EPISODES, seed, sc_errs)
    timed(4, phase_beergame, B, CHECK_EPISODES, seed, bg_errs)
    res = timed(5, phase_main_path, B, MAIN_EPISODES, seed, REPS)
    timed(6, phase_policy, B, CHECK_EPISODES, seed, pol_errs)
    upd = timed(7, phase_ppo_update, seed, pu_errs)
    tr = timed(8, phase_trainer, seed)
    ep = timed(9, phase_episode, B, seed, ep_errs)
    ev = timed(10, phase_eval, seed)
    dn = timed(11, phase_dense, B, seed)
    bge = timed(12, phase_beergame_episode, B, seed)
    dm = timed(13, phase_demand, B, seed, dm_errs)
    bf = timed(14, phase_bf16_beergame, seed)
    hs = timed(15, phase_host_streams, B, seed)
    mh = timed(16, phase_multihost, seed)
    tp = timed(17, phase_tensor_parallel, seed)
    ln = timed(18, phase_learning, seed)
    print(f"seconds a phase (host clock; phase 2 holds 3, phase 1 the build): "
          f"{seconds}, all {round(time.perf_counter() - t0, 1)}")

    kernels = _kernel_lines(res, tr, upd, ep, ev, dn, bge, dm, bf, hs, mh, tp,
                            ln, sc_errs, bg_errs, pol_errs, pu_errs, ep_errs,
                            dm_errs)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
