"""Traffic kind ``train_dp``: iterations of the fused trainer, data-parallel
over a cell's ranks.

Each rank joins the program's process group (``parallel/mesh.py``'s
``init_distributed``: NCCL with a card a rank, gloo on the CPU) and builds
the configuration's ``mesh`` (``{"data": d, "model": m}``; a world of ranks
that is not ``d x m`` is refused) and on it the program's
``make_ppo_fused(..., noise="prng", mesh=)`` with the update kernel.  The
traffic's ``batch`` is the global one: a rank collects its ``batch / d``
lanes at their global ``lane0`` and the ranks average their gradients,
advantage statistics and metrics over the data group.  An iteration, and
the traced window's spans (``collect``, ``prepare``, ``update``), are
``drivers/train.py``'s.

Each rank first takes its own share of the host's cores
(``os.sched_setaffinity``: rank r of w the r-th of w equal slices of the
cores the process may use; threads started later, NCCL's among them,
inherit it), so that the ranks' host loops, on which every all-reduce
waits, do not contend for a core.

Set-up builds the trainer from the run's seed, the same on every rank, and
drives it through its first ``checked_iterations`` iterations, as
``train.py`` does.  ``cell.work`` is an iteration's global env-steps; the
bounds and FLOPs in ``cell.shape`` are the rank's (its lanes), so the
rooflines and ``mfu.train`` read a card.  ``cell.shape["allreduce_calls"]``
is the data group's all-reduces an iteration over the checked iterations
(the program's counter ``collective.data``), left out where the program
counts none.

The check holds each rank's numbers against the plain reference
(``perfbench/reference/ppo.py::train``) at the global batch on the rank's
own device: with equal shards the ranks' mean gradients are the global
batch's, so the unsharded reference is the sharded run's.  Beside
``train.py``'s numbers, ``replica_gap``: the largest difference of any
parameter between two ranks after the checked iterations (one all-reduce
of MAX), 0 where the replicas are bit-equal, as the trainer promises.  The
check ends the group.
"""
from __future__ import annotations

import os
import sys

import torch

from .. import counts
from ..reference.chain import compile_chain
from . import train
from .train import RATE, SPANS, TAIL, control  # noqa: F401

__all__ = ["RATE", "TAIL", "SPANS", "build", "control"]


def _collective_calls():
    from gym_supplychain_tpu_torch.utils.profiling import counters

    c = counters()
    return c.get("collective.data", 0), c.get("collective.data_bytes", 0)


_CORES = sorted(os.sched_getaffinity(0))    # the cores the process may use


def _own_cores(rank: int, world: int):
    """Restrict the calling thread to the rank's slice of the cores the
    process may use and return the slice; nothing where there are fewer
    cores than ranks."""
    share = len(_CORES) // world
    if not share:
        return None
    mine = _CORES[rank * share:(rank + 1) * share]
    os.sched_setaffinity(0, mine)
    return mine


class Cell(train.Cell):
    def __init__(self, ctx):
        import gym_supplychain_tpu_torch as port
        from gym_supplychain_tpu_torch.learn.ppo import (PPOConfig,
                                                         make_ppo_fused)
        from gym_supplychain_tpu_torch.parallel.mesh import (
            init_distributed, make_mesh)

        cfg, tr = ctx.config, ctx.traffic
        data, model = int(cfg["mesh"]["data"]), int(cfg["mesh"]["model"])
        if data * model != ctx.world:
            raise ValueError(f"mesh {data}x{model}: the cell runs "
                             f"{ctx.world} ranks")
        cores = _own_cores(ctx.rank, ctx.world)
        print(f"rank {ctx.rank}: host cores {cores}", file=sys.stderr)
        init_distributed(device=ctx.device)
        mesh = make_mesh(data, model, device=ctx.device)
        self.ctx, self.B = ctx, int(tr["batch"])
        self.ch = compile_chain(cfg["chain"], cfg["horizon"])
        ppo = cfg["ppo"]
        pc = PPOConfig(
            epochs=ppo["epochs"], gamma=ppo["gamma"], lam=ppo["lam"],
            clip=ppo["clip"], lr=ppo["lr"], ent_coef=ppo["ent_coef"],
            vf_coef=ppo["vf_coef"], max_grad_norm=ppo["max_grad_norm"],
            pre_tanh_reg=ppo["pre_tanh_reg"], hidden=tuple(cfg["hidden"]),
            minibatches=ppo["minibatches"], fused_update=True,
            learner_dtype=train._learner(cfg))
        cc = port.make_chain(cfg["env_id"], total_time_steps=cfg["horizon"])
        init_fn, self.train_step = make_ppo_fused(
            cc, self.B, pc, noise="prng", reward_scale=ppo["reward_scale"],
            device=ctx.device, mesh=mesh)
        self.state = init_fn(ctx.seed)
        flat = self.state.params.flat()
        self.prog = {"params0": [p.detach().clone() for p in flat]}

        def first_step(opt, args, kwargs):
            if "grad1" not in self.prog:
                self.prog["grad1"] = [
                    opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    / (1 - 0.9) for p in flat]

        hook = self.state.opt.register_step_post_hook(first_step)
        n_iter = int(tr["checked_iterations"])
        calls0, bytes0 = _collective_calls()
        losses = []
        for _ in range(n_iter):
            self.state, metrics = self.train_step(self.state)
            losses.append(metrics["loss"])
        hook.remove()
        calls1, bytes1 = _collective_calls()
        self.prog["loss"] = [float(x) for x in losses]
        self.prog["params"] = [p.detach().clone() for p in flat]
        ch, T, H = self.ch, self.ch.T, cfg["hidden"]
        lanes = self.B // data
        M = T * lanes                   # the rank's samples an iteration
        self.work = T * self.B
        self.shape = {
            "bound_ms": {
                "collect": counts.k1_policy_bound(ch.obs_dim, ch.A, ch.N,
                                                  ch.P, H, T, lanes)[0],
                "update": ppo["epochs"] * counts.k2_bound(
                    ch.obs_dim, ch.A, H, M)[0]},
            "flops": counts.train_flops(ch.obs_dim, ch.A, H, M,
                                        ppo["epochs"])}
        if calls1 > calls0:
            self.shape["allreduce_calls"] = (calls1 - calls0) / n_iter
            print(f"rank {ctx.rank}: the data group's all-reduces an "
                  f"iteration: {(calls1 - calls0) / n_iter:g}, "
                  f"{(bytes1 - bytes0) / n_iter:g} bytes a rank",
                  file=sys.stderr)

    def check(self):
        import torch.distributed as dist

        flat = torch.cat([p.reshape(-1) for p in self.prog["params"]])
        both = torch.cat([flat, -flat])
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        # the most over the ranks less the least, parameter by parameter
        gap = float((both[:flat.numel()] + both[flat.numel():]).max())
        dist.destroy_process_group()
        numbers = super().check()
        numbers["replica_gap"] = gap
        return numbers


def build(ctx):
    return Cell(ctx)
