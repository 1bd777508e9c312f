"""Training CLI: PPO over batched supply-chain envs, on one device or
over processes on a ``data x model`` mesh.

Usage:
    python -m gym_supplychain_tpu_torch.learn.train --env supplychain-ntom-v0 \\
        --envs 4096 --horizon 60 --iters 200

It runs on the card (``--device cuda``, the default) and stops with an
error where there is none; ``--device cpu`` asks for the CPU.  On a CUDA
device the trainer defaults to fused collection (the collect kernel's
policy mode, ``make_ppo_fused``) and, with it, the fused update (the PPO
update kernel), as the JAX CLI ties them; ``--no-fused`` selects the scan
trainer and autograd, ``--no-fused-update`` autograd alone.  On the CPU
the scan trainer runs.  ``--learner-dtype bf16``
runs the update in bf16 (the update kernel's bf16 mode, or the bf16 trunks
under autograd).  ``--env beergame-v0`` / ``beergame-v2`` trains the beer
game's categorical policy (``make_beergame_ppo``, autograd updates;
``--fused``, ``--fused-update`` and ``--learner-dtype`` are the supply
chains' and stop with an error there, as in the JAX CLI).  One JSON line
of metrics every ``--log-every`` iterations.  ``--checkpoint-dir`` writes the train state
after the last iteration (``step_<iters>.pt``); ``--restore`` loads one
before the first (``utils/checkpoint.py``).  ``--trace-dir`` traces the
training loop (``utils/profiling.py::trace``: a Chrome trace a rank that
carries the program's spans, ``gsc.ppo.collect``, ``gsc.ppo.gae``,
``gsc.ops.ppo_update`` and the rest, beside the device's operations).

``--multihost`` trains over the processes of a group on a ``data x
model`` mesh (``parallel/mesh.py``): launch one process a rank with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), e.g. ``torchrun --nproc-per-node 2 -m
gym_supplychain_tpu_torch.learn.train --multihost --envs 8192``.
``--envs`` is the global batch; each rank runs its data index's share of
the lanes on ``cuda:(local rank % cards)`` (``--device cpu``: the CPU),
over NCCL where every rank has a card of its own and gloo where ranks
outnumber cards.  ``--model-axis M`` makes the mesh ``world / M`` by ``M``:
the ranks of a model group split the policy trunks' hidden units (tensor
parallelism; ``torchrun --nproc-per-node 2 -m
gym_supplychain_tpu_torch.learn.train --multihost --model-axis 2
--no-fused [--fused-update]``).  As in the JAX CLI, fused collection
defaults off on a model axis, an explicit ``--fused`` with one stops with
an error, and ``--fused-update`` runs the update kernel on the gathered
net.  Only rank 0 logs and writes the checkpoint; the ``# engine:`` line
names the backend, the world size and the mesh.  Without a group to join,
``--multihost`` stops with an error.

The flags are those of ``gym_supplychain_tpu.learn.train``, plus
``--device``.  The JAX CLI ignores ``--model-axis`` on one device; here
``--model-axis > 1`` without ``--multihost`` stops with an error instead,
and so does a model axis that does not divide every ``--hidden`` width or
the world size.
"""
from __future__ import annotations

import argparse


def device_from_flag(name: str):
    """The ``--device`` of a CLI as a ``torch.device``; stops with an error
    for a CUDA device where there is none (never falls back to the CPU)."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: the port runs on cuda or cpu")
    return device


def resolve_engine_flags(args, supplychain: bool, device) -> None:
    """Fill the unset ``--fused`` / ``--fused-update``: fused collection
    for the supply chains on a CUDA device without a model axis, and the
    fused update only with fused collection (JAX ``learn/train.py``)."""
    if args.fused is None:
        args.fused = (supplychain and device.type == "cuda"
                      and getattr(args, "model_axis", 1) == 1)
    if args.fused_update is None:
        args.fused_update = (args.fused and supplychain
                             and device.type == "cuda")


def _refuse(args):
    """Stop on flags that do not go together."""
    if args.model_axis < 1:
        raise SystemExit(f"--model-axis {args.model_axis}: at least 1")
    if args.env.startswith("beergame"):
        for flag, value in (("--fused", args.fused),
                            ("--fused-update", args.fused_update),
                            ("--learner-dtype", args.learner_dtype)):
            if value:
                raise SystemExit(f"{flag} supports the continuous-action "
                                 "supply-chain trainers only")
    if args.model_axis == 1:
        return
    if args.fused:
        raise SystemExit("--fused shards the collection kernel over the "
                         "'data' axis with replicated params; --model-axis "
                         "applies to the scan-path trainer only")
    if not args.multihost:
        raise SystemExit(f"--model-axis {args.model_axis} splits the "
                         "hidden units over the ranks of a process group: "
                         "pass --multihost and launch one process a rank")
    bad = [h for h in args.hidden if h % args.model_axis]
    if bad:
        raise SystemExit(f"--model-axis {args.model_axis} does not divide "
                         f"the --hidden widths {bad}")


def join_mesh(args):
    """``--multihost``: join the process group and build the ``world /
    model_axis`` by ``model_axis`` mesh; stops with an error where there is
    no group of two or more processes to join (it never trains alone) or
    the model axis does not divide it.  None without the flag."""
    if not args.multihost:
        return None
    from ..parallel.mesh import init_distributed, make_mesh

    try:
        dev = init_distributed(device=args.device)
    except RuntimeError as e:
        raise SystemExit(f"--multihost: {e}") from None
    if dev is None:
        raise SystemExit("--multihost: no process group to join (set "
                         "WORLD_SIZE > 1, RANK, MASTER_ADDR and MASTER_PORT, "
                         "as torchrun does)")
    try:
        return make_mesh(model=args.model_axis, device=dev)
    except ValueError as e:
        import torch.distributed as dist

        dist.destroy_process_group()
        raise SystemExit(f"--model-axis {args.model_axis}: {e}") from None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env", default="supplychain-ntom-v0")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--rollout-steps", type=int, default=16)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--horizon", type=int, default=360)
    p.add_argument("--model-axis", type=int, default=1,
                   help="tensor-parallel degree over policy hidden dims")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="collect whole episodes through the collect "
                        "kernel's policy mode (learn/ppo.py::make_ppo_fused)"
                        ".  DEFAULT ON on a CUDA device; --no-fused selects "
                        "the scan trainer")
    p.add_argument("--fused-episodes", type=int, default=1)
    p.add_argument("--fused-update", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="run the update's forward+loss+backward as one CUDA "
                        "kernel (ops/ppo_update.py).  DEFAULT: on with fused "
                        "collection on a CUDA device")
    p.add_argument("--learner-dtype", default=None, choices=[None, "bf16"],
                   help="update-phase compute dtype (the rollout is "
                        "unaffected)")
    p.add_argument("--minibatches", type=int, default=1,
                   help="contiguous minibatches per PPO epoch")
    p.add_argument("--multihost", action="store_true",
                   help="train over the processes of a group (torchrun's "
                        "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) on a "
                        "world/M x M mesh (M = --model-axis); --envs is "
                        "the global batch")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--restore", default=None)
    p.add_argument("--trace-dir", default=None,
                   help="write a Chrome trace of the training loop a rank "
                        "(torch.profiler, with the program's gsc.* spans) "
                        "under this directory")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error where there is no card) or "
                        "cpu")
    args = p.parse_args(argv)
    _refuse(args)
    device_from_flag(args.device)
    mesh = join_mesh(args)
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, mesh):
    import torch

    from .. import make_chain
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint
    from ..utils.profiling import Throughput, log_metrics, trace
    from .ppo import PPOConfig, make_beergame_ppo, make_ppo, make_ppo_fused

    device = mesh.device if mesh is not None else device_from_flag(
        args.device)
    lead = mesh is None or mesh.rank == 0     # the rank that logs and writes
    supplychain = not args.env.startswith("beergame")
    resolve_engine_flags(args, supplychain, device)
    cfg = PPOConfig(rollout_steps=args.rollout_steps, epochs=args.epochs,
                    lr=args.lr, hidden=tuple(args.hidden),
                    minibatches=args.minibatches,
                    learner_dtype=(torch.bfloat16
                                   if args.learner_dtype == "bf16" else None),
                    fused_update=args.fused_update)
    if lead:
        print(f"# engine: device={device} fused_collect={bool(args.fused)} "
              f"fused_update={bool(args.fused_update)} "
              f"learner_dtype={args.learner_dtype or 'float32'} "
              f"backend={mesh.backend if mesh else 'none'} "
              f"world={mesh.world if mesh else 1} "
              f"mesh={mesh.data if mesh else 1}x{mesh.model if mesh else 1}")
    if not supplychain:
        init_fn, train_step = make_beergame_ppo(
            args.envs, cfg, v2=args.env.endswith("v2"), device=device,
            mesh=mesh)
        steps_per_iter = cfg.rollout_steps
    elif args.fused:
        cc = make_chain(args.env, total_time_steps=args.horizon)
        init_fn, train_step = make_ppo_fused(cc, args.envs, cfg,
                                             episodes=args.fused_episodes,
                                             device=device, mesh=mesh)
        steps_per_iter = args.horizon * args.fused_episodes
    else:
        cc = make_chain(args.env, total_time_steps=args.horizon)
        init_fn, train_step = make_ppo(cc, args.envs, cfg, device=device,
                                       mesh=mesh)
        steps_per_iter = cfg.rollout_steps

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state = init_fn(args.seed)
    if args.restore:
        state = restore_checkpoint(args.restore, like=state, mesh=mesh)
    meter = Throughput(args.envs * steps_per_iter)    # the global batch
    metrics, last = None, 0
    with trace(args.trace_dir):
        for it in range(args.iters):
            state, metrics = train_step(state)
            if it == 0:
                sync()
                meter.reset()      # exclude the kernels' build from steps/s
                last = 1
            elif (it + 1) % args.log_every == 0 or it + 1 == args.iters:
                sync()
                sps = meter.update(it + 1 - last)
                last = it + 1
                if lead:
                    log_metrics(it + 1, {**metrics, "env_steps_per_s": sps})
        sync()
    if args.trace_dir and lead:
        print(f"# trace: {args.trace_dir}")
    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, state, step=args.iters,
                               mesh=mesh)
        if lead:
            print(f"# checkpoint: {path}")
    return state, metrics


if __name__ == "__main__":
    main()
