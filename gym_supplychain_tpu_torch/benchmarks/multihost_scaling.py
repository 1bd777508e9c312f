"""The PPO trainers over processes on ``data x model`` meshes.

The counterpart of the JAX repo's ``benchmarks/multihost_scaling.py``: PPO
on ``supplychain-ntom-v0`` (the north-star config of ``BASELINE.json``,
8192 envs) with the env batch split over the data axis of a
``torch.distributed`` group (``parallel/mesh.py``), each rank one OS
process, and the policy trunks' hidden units split over its model axis.
On a machine with a card a rank the group runs NCCL; where ranks outnumber
cards (two ranks on one card) gloo, and the ranks time-share the card's
SMs, so the rates are not a scaling figure there.

Each entry of ``meshes`` is a mesh shape ``(data, model)`` (on the command
line ``DxM``, or ``W`` for the ``W x 1`` mesh).  For each it spawns the
ranks, builds the
kernels once before (into the ignored ``_build/``), waits for them under a
deadline (a rank that fails or dies fails the run) and prints one JSON
line: ``processes``, ``mesh`` ``[data, model]``, ``global_envs``,
``backend`` and, for each trainer case it ran (``cases``):

* ``fused``: ``make_ppo_fused`` (K1 ``policy``, and K2 on a card);
* ``scan``, ``scan-k2``, ``scan-k2-bf16``: ``make_ppo`` with autograd, the
  update kernel (K2, on the net gathered over the model axis) or its bf16
  mode;
* ``beergame``: ``make_beergame_ppo`` on beergame-v2 with the stochastic
  ranges of ``bench.py``'s v2 config (demand [0, 12), delays [0, 4)),

the first iteration's ``first`` metrics, ``train_env_steps_per_s``
(global env-steps over rank 0's wall time of the timed iterations) and
``iter_ms``; the data group's all-reduce (``allreduce_ms_per_call``: one
all-reduce of the step's packed gradients, timed alone from a barrier to
the card's synchronize, the median of 20;
``allreduce_calls_per_iter``; their product) and the model group's
collectives (``model_calls_per_iter``; ``model_gather_ms`` and
``model_reduce_scatter_ms``, one of each at the update's activation shape,
and ``model_gather_rollout_ms`` at the rollout's, timed alone the same
way); whether
the replicated leaves (``replicated``) and the gathered net
(``gathered_equal``) are bit-equal on every rank; whether a checkpoint
written by the ranks resumes bit for bit (``resume_bit_exact``); on a model
axis, whether the 1-process file of the same case (written by an earlier
entry of ``meshes`` in the same call) restores into each rank's rows, or
the whole net where the trainer keeps it whole (``from_one_rows``) and whether this mesh's file restores in one process
to the gathered net (``to_one_bit_exact``); for the beer game, whether
each rank's episode tables are its lanes of the global draw
(``tables_global``); and the kernels' launches, summed over the ranks and
the fewest on one rank (``launches``, ``launches_min``).  The first case's
keys are repeated at the top level.

    python -m gym_supplychain_tpu_torch.benchmarks.multihost_scaling \\
        [--meshes 1 2 1x2] [--cases scan scan-k2] \\
        [--envs 8192] [--horizon 60] [--iters 5]

``--device cpu --envs 16 --horizon 6 --hidden 16 16 --iters 2`` runs it
here on the plain versions over gloo.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["run", "run_rank", "main", "CASES"]

ROOT = Path(__file__).resolve().parents[2]      # the checkout
ENV = "supplychain-ntom-v0"
CASES = ("fused", "scan", "scan-k2", "scan-k2-bf16", "beergame")
COLLECTIVE_REPS = 20       # collectives of a step's shapes, timed alone
_RESULT = "RESULT "


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(params):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in params.flat()])


def _trainer(case: str, args, mesh, device):
    """``(init_fn, step, env-steps an iteration, the launch counters
    (``utils/profiling.py``) by kernel name, whether the trunks are sharded
    over the model axis)`` of a case."""
    import torch

    from .. import make_chain
    from ..learn.ppo import (PPOConfig, make_beergame_ppo, make_ppo,
                             make_ppo_fused)
    cuda = torch.device(device).type == "cuda"
    cfg = PPOConfig(epochs=args.epochs, hidden=tuple(args.hidden))
    if case == "beergame":
        init_fn, step = make_beergame_ppo(
            args.envs, cfg, v2=True, customer_demand=(0, 12),
            shipment_delays=(0, 4), device=device, mesh=mesh)
        return init_fn, step, cfg.rollout_steps, {}, True
    cc = make_chain(ENV, total_time_steps=args.horizon)
    if case == "fused":
        init_fn, step = make_ppo_fused(
            cc, args.envs, cfg._replace(fused_update=cuda), device=device,
            mesh=mesh)
        return (init_fn, step, cc.T,
                {"supplychain_collect[policy]": "launch.supplychain_policy",
                 "ppo_update": "launch.ppo_update"}, False)
    bf16 = case == "scan-k2-bf16"
    cfg = cfg._replace(fused_update=case != "scan",
                       learner_dtype=torch.bfloat16 if bf16 else None)
    kernels = {
        "scan": {}, "scan-k2": {"ppo_update": "launch.ppo_update"},
        "scan-k2-bf16": {"ppo_update_bf16": "launch.ppo_update_bf16",
                         "ppo_update_bf16_mma": "launch.ppo_update_bf16_mma"},
    }[case]
    init_fn, step = make_ppo(cc, args.envs, cfg, device=device, mesh=mesh)
    return init_fn, step, cfg.rollout_steps, kernels, True


def _median_ms(fn, mesh, sync, reps: int) -> float:
    """The median ms of ``fn`` over ``reps`` calls, each timed from every
    rank's barrier (``sync``) to the card's synchronize: the barrier stays
    outside the timed span."""
    import torch

    ms = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def _collective_ms(mesh, state, args, sync) -> dict:
    """The collectives of a step's shapes on this mesh, each timed alone
    (median ms a call; 0.0 where the axis has one rank)."""
    import torch

    from ..learn.ppo import PPOConfig
    from ..parallel.mesh import (all_reduce_mean_, gather_rows,
                                 reduce_scatter_rows)

    dev, T = mesh.device, PPOConfig().rollout_steps
    n = sum(p.numel() for p in state.params.flat()) + 1
    out = dict(allreduce_ms_per_call=0.0, model_gather_ms=0.0,
               model_reduce_scatter_ms=0.0, model_gather_rollout_ms=0.0)
    if mesh.data > 1:
        buf = torch.zeros(n, device=dev)
        out["allreduce_ms_per_call"] = _median_ms(
            lambda: all_reduce_mean_(mesh, buf), mesh, sync, COLLECTIVE_REPS)
    if mesh.model > 1:
        lanes = args.envs // mesh.data
        rows = args.hidden[0] // mesh.model
        upd = [torch.zeros(rows, T * lanes, device=dev)] * 2
        roll = [torch.zeros(rows, lanes, device=dev)] * 2
        whole = [torch.zeros(rows * mesh.model, T * lanes, device=dev)] * 2
        for key, fn, xs in (("model_gather_ms", gather_rows, upd),
                            ("model_reduce_scatter_ms", reduce_scatter_rows,
                             whole),
                            ("model_gather_rollout_ms", gather_rows, roll)):
            out[key] = _median_ms(lambda: fn(mesh, xs), mesh, sync,
                                  COLLECTIVE_REPS)
    return out


def _all_true(mesh, flags):
    """Each flag and-ed over the ranks (every rank gets the same)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                     device=mesh.device)
    if mesh.world > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return [bool(x) for x in t.tolist()]


def _tables_global(case: str, args, mesh, state) -> bool:
    """Whether the rank's first beer-game tables are its lanes of the
    global batch's (one process's) draw under the same seed."""
    import torch

    from ..parallel.mesh import lane_range

    init1 = _trainer(case, args, None, mesh.device)[0]
    whole = init1(args.seed).env.env
    lo, hi = lane_range(mesh, args.envs)
    return all(torch.equal(getattr(state.env.env, k),
                           getattr(whole, k)[..., lo:hi])
               for k in ("customer_demand", "shipment_delays"))


def _case(case: str, args, mesh, work: str) -> dict:
    """One case on this rank: train, time, check replication, resume and
    the checkpoint's moves.  Every rank returns the same dict."""
    import torch
    import torch.distributed as dist

    from ..models.policy import gather_params, shard_params, trunk_leaves
    from ..parallel.mesh import barrier, replicated
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint
    from ..utils.profiling import counters, reset_counters

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        barrier(mesh)

    init_fn, step, steps, kernels, sharded = _trainer(case, args, mesh,
                                                      mesh.device)

    def whole(params):
        return gather_params(params, mesh) if sharded else params

    reset_counters()
    state = init_fn(args.seed)
    checks = {}
    if case == "beergame":
        checks["tables_global"] = _tables_global(case, args, mesh, state)
    state, m = step(state)               # the build, then iteration 1
    first = {k: float(v) for k, v in m.items()}
    sync()
    stats0 = dict(mesh.stats)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, m = step(state)
    sync()
    dt = time.perf_counter() - t0
    per_iter = {k: (mesh.stats[k] - stats0[k]) / args.iters
                for k in ("data", "model")}
    counted = counters()
    launches = torch.tensor([counted.get(k, 0) for k in kernels.values()]
                            or [0], dtype=torch.int64, device=mesh.device)
    fewest = launches.clone()
    if mesh.world > 1:
        dist.all_reduce(launches, group=mesh.group)
        dist.all_reduce(fewest, op=dist.ReduceOp.MIN, group=mesh.group)
    trunk = {id(p) for p in trunk_leaves(state.params)} if sharded else set()
    repl = torch.cat([p.detach().reshape(-1) for p in state.params.flat()
                      if id(p) not in trunk])
    checks["replicated"] = replicated(mesh, repl)
    checks["gathered_equal"] = replicated(mesh, _flat(whole(state.params)))
    timing = _collective_ms(mesh, state, args, sync)

    # the checkpoint the ranks write resumes bit for bit, and moves
    shape = f"{mesh.data}x{mesh.model}"
    path = save_checkpoint(os.path.join(work, f"ck_{shape}_{case}"), state,
                           step=1 + args.iters, mesh=mesh)
    saved = _flat(whole(state.params))
    state, _ = step(state)
    cont = _flat(whole(state.params))
    fresh, _ = step(restore_checkpoint(path, like=init_fn(args.seed + 1),
                                       mesh=mesh))
    checks["resume_bit_exact"] = torch.equal(cont, _flat(whole(fresh.params)))
    one_path = os.path.join(work, f"ck_1x1_{case}")
    if mesh.model > 1 and os.path.isdir(one_path):
        got = restore_checkpoint(one_path, like=init_fn(args.seed + 1),
                                 mesh=mesh)
        rows = restore_checkpoint(one_path)["params"].to(mesh.device)
        if sharded:
            rows = shard_params(rows, mesh)
        checks["from_one_rows"] = all(
            torch.equal(a, b) for a, b in zip(got.params.flat(), rows.flat()))
    if mesh.model > 1:
        ok = True
        if mesh.rank == 0:
            init1, _, _, _, _ = _trainer(case, args, None, mesh.device)
            one = restore_checkpoint(path, like=init1(args.seed + 1))
            ok = torch.equal(_flat(one.params), saved)
        checks["to_one_bit_exact"] = ok
    checks = dict(zip(checks, _all_true(mesh, checks.values())))
    global_steps = args.envs * steps * args.iters
    names = list(kernels)
    return dict(
        first=first, iter_ms=dt / args.iters * 1e3,
        train_env_steps_per_s=global_steps / dt,
        allreduce_calls_per_iter=per_iter["data"],
        allreduce_ms_per_iter=(timing["allreduce_ms_per_call"]
                               * per_iter["data"]),
        model_calls_per_iter=per_iter["model"], **timing, **checks,
        launches=dict(zip(names, launches.tolist())),
        launches_min=dict(zip(names, fewest.tolist())))


def run_rank(args) -> dict:
    """One rank's run (every process of a mesh runs it): join the group,
    build the mesh, run each case.  Returns rank 0's result (None on the
    other ranks)."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, make_mesh

    dev = init_distributed(device=args.device)
    data, model = args.mesh
    mesh = make_mesh(data, model, device=dev or args.device)
    try:
        cases = {c: _case(c, args, mesh, args.work_dir) for c in args.cases}
        out = dict(processes=mesh.world, mesh=[mesh.data, mesh.model],
                   global_envs=args.envs,
                   lanes_per_rank=args.envs // mesh.data,
                   backend=mesh.backend, device=str(mesh.device),
                   horizon=args.horizon, hidden=list(args.hidden),
                   iters=args.iters, **cases[args.cases[0]], cases=cases)
        return out if mesh.rank == 0 else None
    finally:
        if mesh.world > 1:
            dist.destroy_process_group()


def _rank_argv(args, mesh, work_dir: str):
    return [sys.executable, "-m",
            "gym_supplychain_tpu_torch.benchmarks.multihost_scaling",
            "--worker", "--mesh-shape", str(mesh[0]), str(mesh[1]),
            "--cases", *args.cases, "--envs", str(args.envs), "--horizon",
            str(args.horizon), "--hidden", *map(str, args.hidden),
            "--epochs", str(args.epochs), "--iters", str(args.iters),
            "--seed", str(args.seed), "--device", args.device,
            "--work-dir", work_dir]


def _spawn(args, mesh, work: str, timeout: float) -> dict:
    """Run the ranks of ``mesh`` to their end under one deadline; the first
    rank that fails (or the deadline) stops the others and fails the
    run."""
    world = mesh[0] * mesh[1]
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
                _rank_argv(args, mesh, work), stdout=out, stderr=err,
                cwd=str(ROOT), env=env))
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
    shape = f"{mesh[0]}x{mesh[1]}"
    for r, (p, (out, err)) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of the {shape} mesh exited "
                               f"{p.returncode} (deadline {timeout} s):\n"
                               f"{out[-2000:]}\n{err[-4000:]}")
    lines = [ln for ln in texts[0][0].splitlines() if ln.startswith(_RESULT)]
    if not lines:
        raise RuntimeError(f"rank 0 of the {shape} mesh printed no "
                           f"result:\n{texts[0][0][-2000:]}")
    return json.loads(lines[-1][len(_RESULT):])


def run(meshes=((1, 1), (2, 1)), envs: int = 8192, horizon: int = 60,
        hidden=(128, 128), epochs: int = 2, iters: int = 5, seed: int = 0,
        device: str = "cuda", timeout: float = 600.0, cases=("fused",)):
    """Spawn and run each ``(data, model)`` mesh of ``meshes`` in turn,
    each running every trainer of ``cases``; returns one result dict a
    mesh (rank 0's).  The kernels are built
    first, in this process; the meshes share one work directory, so a
    later mesh restores an earlier one's checkpoints."""
    unknown = [c for c in cases if c not in CASES]
    if unknown:
        raise ValueError(f"cases {unknown}: one of {CASES}")
    if device != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass device='cpu' to run on "
                               "the CPU)")
        from ..ops import _build

        _build.library()
    args = argparse.Namespace(envs=envs, horizon=horizon, hidden=list(hidden),
                              epochs=epochs, iters=iters, seed=seed,
                              device=device, cases=list(cases))
    with tempfile.TemporaryDirectory() as work:
        return [_spawn(args, tuple(m), work, timeout) for m in meshes]


def _mesh_arg(text: str):
    """``DxM`` as ``(D, M)``; ``W`` as ``(W, 1)``."""
    data, _, model = text.lower().partition("x")
    return int(data), int(model or 1)


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--meshes", type=_mesh_arg, nargs="+",
                   default=[(1, 1), (2, 1)],
                   help="mesh shapes DxM (data x model); W is Wx1")
    p.add_argument("--cases", nargs="+", default=["fused"], choices=CASES)
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
                   help="seconds a mesh may take")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mesh-shape", type=int, nargs=2, default=None,
                   dest="mesh", help=argparse.SUPPRESS)
    p.add_argument("--work-dir", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.worker:
        out = run_rank(args)
        if out is not None:
            print(_RESULT + json.dumps(out), flush=True)
        return out
    results = run(args.meshes, envs=args.envs, horizon=args.horizon,
                  hidden=args.hidden, epochs=args.epochs, iters=args.iters,
                  seed=args.seed, device=args.device, timeout=args.timeout,
                  cases=args.cases)
    for r in results:
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
