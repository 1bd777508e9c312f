"""Training CLI: PPO over batched supply-chain envs, on one device.

Usage:
    python -m gym_supplychain_tpu_torch.learn.train --env supplychain-ntom-v0 \\
        --envs 4096 --horizon 60 --iters 200

On a CUDA device the trainer defaults to fused collection (the collect
kernel's policy mode, ``make_ppo_fused``) and the fused update (the PPO
update kernel); ``--no-fused`` / ``--no-fused-update`` select the scan
trainer and autograd.  On the CPU the scan trainer runs.  One JSON line of
metrics every ``--log-every`` iterations.

The flags are those of ``gym_supplychain_tpu.learn.train``.  Those whose
modules are not ported yet (multi-process and tensor-parallel training,
checkpoints, traces, the bf16 learner, the beer game's trainer) stop with
an error instead of being ignored.
"""
from __future__ import annotations

import argparse

_UNPORTED = "is not ported to the PyTorch package yet"


def _refuse(args):
    """Stop on a flag whose module is not ported."""
    checks = [
        (args.multihost, "--multihost (multi-process training)"),
        (args.model_axis > 1, "--model-axis > 1 (tensor parallelism)"),
        (args.checkpoint_dir, "--checkpoint-dir (checkpoints)"),
        (args.restore, "--restore (checkpoints)"),
        (args.trace_dir, "--trace-dir (device traces)"),
        (args.learner_dtype == "bf16", "--learner-dtype bf16"),
        (args.env.startswith("beergame"),
         f"--env {args.env} (the beer game's discrete trainer)"),
    ]
    for bad, what in checks:
        if bad:
            raise SystemExit(f"{what} {_UNPORTED}")


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
                        "kernel (ops/ppo_update.py).  DEFAULT ON on a CUDA "
                        "device")
    p.add_argument("--learner-dtype", default=None, choices=[None, "bf16"],
                   help="update-phase trunk compute dtype")
    p.add_argument("--minibatches", type=int, default=1,
                   help="contiguous minibatches per PPO epoch")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--restore", default=None)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--log-every", type=int, default=10)
    args = p.parse_args(argv)
    _refuse(args)

    import torch

    from .. import make_chain
    from ..utils.profiling import Throughput, log_metrics
    from .ppo import PPOConfig, make_ppo, make_ppo_fused

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    on_cuda = device.type == "cuda"
    if args.fused is None:
        args.fused = on_cuda
    if args.fused_update is None:
        args.fused_update = on_cuda
    cfg = PPOConfig(rollout_steps=args.rollout_steps, epochs=args.epochs,
                    lr=args.lr, hidden=tuple(args.hidden),
                    minibatches=args.minibatches,
                    fused_update=args.fused_update)
    print(f"# engine: device={device} fused_collect={bool(args.fused)} "
          f"fused_update={bool(args.fused_update)}")
    cc = make_chain(args.env, total_time_steps=args.horizon)
    if args.fused:
        init_fn, train_step = make_ppo_fused(cc, args.envs, cfg,
                                             episodes=args.fused_episodes,
                                             device=device)
        steps_per_iter = args.horizon * args.fused_episodes
    else:
        init_fn, train_step = make_ppo(cc, args.envs, cfg, device=device)
        steps_per_iter = cfg.rollout_steps

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    state = init_fn(args.seed)
    meter = Throughput(args.envs * steps_per_iter)
    metrics, last = None, 0
    for it in range(args.iters):
        state, metrics = train_step(state)
        if it == 0:
            sync()
            meter.reset()          # exclude the kernels' build from steps/s
            last = 1
        elif (it + 1) % args.log_every == 0 or it + 1 == args.iters:
            sync()
            sps = meter.update(it + 1 - last)
            last = it + 1
            log_metrics(it + 1, {**metrics, "env_steps_per_s": sps})
    sync()
    return state, metrics


if __name__ == "__main__":
    main()
