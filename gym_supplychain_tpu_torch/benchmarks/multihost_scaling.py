"""Data-parallel scaling of the PPO trainer over processes.

The counterpart of the JAX repo's ``benchmarks/multihost_scaling.py``: PPO
on ``supplychain-ntom-v0`` (the north-star config of ``BASELINE.json``,
8192 envs) with the env batch split over W ranks of a
``torch.distributed`` group (``parallel/mesh.py``), each rank one OS
process running ``make_ppo_fused`` on its lanes (K1 ``policy``, K2), the
gradients averaged by one all-reduce a step.  On a machine with a card a
rank the group runs NCCL; where ranks outnumber cards (two ranks on one
card) gloo, and the ranks time-share the card's SMs, so the rates are not
a scaling figure there.

For each process count it spawns the ranks, builds the kernels once before
(into the ignored ``_build/``), waits for them under a deadline (a rank
that fails or dies fails the run) and prints one JSON line: ``processes``,
``global_envs``, ``backend``, ``train_env_steps_per_s`` (global env-steps
over rank 0's wall time of the timed iterations), ``iter_ms``, the
all-reduce's ``allreduce_ms_per_iter`` (the ms of one all-reduce of the
step's packed gradients, timed alone, times the collectives an iteration
issued), the first iteration's ``first`` metrics, whether the ranks'
parameters are bit-equal (``replicated``), whether a checkpoint written by
the ranks resumes bit for bit (``resume_bit_exact``), and the kernels'
launches summed over the ranks.

    python -m gym_supplychain_tpu_torch.benchmarks.multihost_scaling \\
        [--processes 1 2] [--envs 8192] [--horizon 60] [--iters 5]

``--device cpu --envs 16 --horizon 6 --hidden 16 16 --iters 2`` runs it
here on the plain versions over gloo.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["run", "run_rank", "main"]

ROOT = Path(__file__).resolve().parents[2]      # the checkout
ENV = "supplychain-ntom-v0"
ALLREDUCE_REPS = 20        # all-reduces of a step's buffer, timed alone
_RESULT = "RESULT "


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat_params(state):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in state.params.flat()])


def run_rank(args) -> dict:
    """One rank's run (every process of a count runs it): join the group,
    train, time, check replication and resume.  Returns rank 0's result
    (None on the other ranks)."""
    import torch
    import torch.distributed as dist

    from .. import make_chain
    from ..learn.ppo import PPOConfig, make_ppo_fused
    from ..ops import ppo_update as pu
    from ..ops import supplychain_collect as scc
    from ..parallel.mesh import (all_reduce_mean_, barrier, init_distributed,
                                 make_mesh, replicated)
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint

    dev = init_distributed(device=args.device)
    mesh = make_mesh(device=dev or args.device)
    try:
        cc = make_chain(ENV, total_time_steps=args.horizon)
        cfg = PPOConfig(epochs=args.epochs, hidden=tuple(args.hidden),
                        fused_update=mesh.device.type == "cuda")
        init_fn, step = make_ppo_fused(cc, args.envs, cfg, mesh=mesh)

        def sync():
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            barrier(mesh)

        counts = (scc.launch_supplychain_policy, pu.launch_ppo_update)
        for fn in counts:
            fn.launches = 0
        state = init_fn(args.seed)
        state, m = step(state)               # the build, then iteration 1
        first = {k: float(v) for k, v in m.items()}
        sync()
        calls0 = mesh.stats["calls"]
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state, m = step(state)
        sync()
        dt = time.perf_counter() - t0
        launches = torch.tensor([fn.launches for fn in counts],
                                dtype=torch.int64, device=mesh.device)
        if mesh.world > 1:
            dist.all_reduce(launches, group=mesh.group)
        calls = (mesh.stats["calls"] - calls0) / args.iters
        flat = _flat_params(state)
        same = replicated(mesh, flat)

        # one all-reduce of the step's packed gradients and loss, alone
        buf = torch.zeros(flat.numel() + 1, dtype=torch.float32,
                          device=mesh.device)
        ms = []
        for _ in range(ALLREDUCE_REPS):
            sync()
            t = time.perf_counter()
            all_reduce_mean_(mesh, buf)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            ms.append((time.perf_counter() - t) * 1e3)
        ar_ms = sorted(ms)[len(ms) // 2] if mesh.world > 1 else 0.0

        # the checkpoint the ranks write resumes bit for bit
        path = save_checkpoint(args.work_dir, state, step=1 + args.iters,
                               mesh=mesh)
        state, _ = step(state)
        cont = _flat_params(state)
        fresh = restore_checkpoint(path, like=init_fn(args.seed + 1),
                                   mesh=mesh)
        fresh, _ = step(fresh)
        ok = torch.tensor([int(torch.equal(cont, _flat_params(fresh)))],
                          dtype=torch.int32, device=mesh.device)
        if mesh.world > 1:
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
        steps = args.envs * cc.T * args.iters
        out = dict(processes=mesh.world, global_envs=args.envs,
                   lanes_per_rank=args.envs // mesh.world,
                   backend=mesh.backend, device=str(mesh.device),
                   horizon=cc.T, hidden=list(cfg.hidden), iters=args.iters,
                   train_env_steps_per_s=steps / dt,
                   iter_ms=dt / args.iters * 1e3,
                   allreduce_ms_per_call=ar_ms,
                   allreduce_calls_per_iter=calls,
                   allreduce_ms_per_iter=ar_ms * calls, first=first,
                   replicated=same, resume_bit_exact=bool(ok.item()),
                   launches={"supplychain_collect[policy]":
                             int(launches[0]),
                             "ppo_update": int(launches[1])})
        return out if mesh.rank == 0 else None
    finally:
        if mesh.world > 1:
            dist.destroy_process_group()


def _rank_argv(args, work_dir: str):
    return [sys.executable, "-m",
            "gym_supplychain_tpu_torch.benchmarks.multihost_scaling",
            "--worker", "--envs", str(args.envs), "--horizon",
            str(args.horizon), "--hidden", *map(str, args.hidden),
            "--epochs", str(args.epochs), "--iters", str(args.iters),
            "--seed", str(args.seed), "--device", args.device,
            "--work-dir", work_dir]


def _spawn(args, world: int, timeout: float) -> dict:
    """Run ``world`` ranks to their end under one deadline; the first rank
    that fails (or the deadline) stops the others and fails the run."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=os.pathsep.join(
                           [str(ROOT)] + [p for p in [os.environ.get(
                               "PYTHONPATH")] if p]))
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                _rank_argv(args, os.path.join(tmp, "ck")),
                stdout=out, stderr=err, cwd=str(ROOT), env=env))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    for r, (p, (out, err)) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited {p.returncode} "
                               f"(deadline {timeout} s):\n{out[-2000:]}\n"
                               f"{err[-4000:]}")
    lines = [ln for ln in texts[0][0].splitlines() if ln.startswith(_RESULT)]
    if not lines:
        raise RuntimeError(f"rank 0 of {world} printed no result:\n"
                           f"{texts[0][0][-2000:]}")
    return json.loads(lines[-1][len(_RESULT):])


def run(processes=(1, 2), envs: int = 8192, horizon: int = 60,
        hidden=(128, 128), epochs: int = 2, iters: int = 5, seed: int = 0,
        device: str = "cuda", timeout: float = 600.0):
    """Spawn and run each process count in turn; returns one result dict a
    count (rank 0's).  The kernels are built first, in this process."""
    if device != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass device='cpu' to run on "
                               "the CPU)")
        from ..ops import _build

        _build.library()
    args = argparse.Namespace(envs=envs, horizon=horizon, hidden=list(hidden),
                              epochs=epochs, iters=iters, seed=seed,
                              device=device)
    return [_spawn(args, int(w), timeout) for w in processes]


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--processes", type=int, nargs="+", default=[1, 2])
    p.add_argument("--envs", type=int, default=8192,
                   help="the global batch")
    p.add_argument("--horizon", type=int, default=60)
    p.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--iters", type=int, default=5,
                   help="timed iterations after the first")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a process count may take")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--work-dir", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.worker:
        out = run_rank(args)
        if out is not None:
            print(_RESULT + json.dumps(out), flush=True)
        return out
    results = run(args.processes, envs=args.envs, horizon=args.horizon,
                  hidden=args.hidden, epochs=args.epochs, iters=args.iters,
                  seed=args.seed, device=args.device, timeout=args.timeout)
    for r in results:
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
