"""Traffic kind ``train``: iterations of the fused trainer.

The program's ``make_ppo_fused(..., noise="prng")`` with the update
kernel (``fused_update``): an iteration collects one whole episode of
every lane through the policy lane kernel, runs GAE, and takes the
configuration's epochs of update-kernel steps with the clip and Adam.  A
step of the window is one ``train_step``.

Set-up builds the trainer from the run's seed and drives it through its
first ``checked_iterations`` iterations (which also warm every shape);
that same state goes on into the window.  Those iterations are what the
plain reference follows: each iteration's loss, the first clipped gradient
as Adam got it (its first moment after one step over ``1 - 0.9``) and the
parameters' change over them, leaf by leaf.

The traced window runs an iteration as ``train_step`` does, phase by
phase, each in a span: ``collect``, ``prepare`` (GAE, normalization, the
update layout) and ``update``.
"""
from __future__ import annotations

import gc

import torch

from .. import compare, counts
from ..reference.chain import compile_chain
from ..reference.ppo import precision, train

RATE, TAIL = "train_env_steps_per_s", "train_iter_ms_p95"
SPANS = ("collect", "prepare", "update")


def _learner(cfg):
    """The trainer's ``learner_dtype`` for the configuration's: float32,
    the one learner this kind's reference and control follow.  Another is
    refused, so that no configuration runs at a precision it does not
    state."""
    if cfg["learner_dtype"] != "float32":
        raise ValueError(f"learner_dtype {cfg['learner_dtype']!r}: the "
                         "train kind runs and checks a float32 learner")
    return None


def _numbers(prog, ref):
    skip = compare.quiet_leaves(ref["grad1"])
    return {
        "loss_gap": max(compare.rel_gap(a, b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad1_gap": compare.leaf_norm_gap(prog["grad1"], ref["grad1"]),
        "change_gap": compare.leaf_norm_gap(
            [a - b for a, b in zip(prog["params"], prog["params0"])],
            [a - b for a, b in zip(ref["params"], ref["params0"])], skip),
    }


class Cell:
    def __init__(self, ctx):
        import gym_supplychain_tpu_torch as port
        from gym_supplychain_tpu_torch.learn.ppo import (PPOConfig,
                                                         make_ppo_fused)

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.B = ctx, int(tr["batch"])
        self.ch = compile_chain(cfg["chain"], cfg["horizon"])
        ppo = cfg["ppo"]
        pc = PPOConfig(
            epochs=ppo["epochs"], gamma=ppo["gamma"], lam=ppo["lam"],
            clip=ppo["clip"], lr=ppo["lr"], ent_coef=ppo["ent_coef"],
            vf_coef=ppo["vf_coef"], max_grad_norm=ppo["max_grad_norm"],
            pre_tanh_reg=ppo["pre_tanh_reg"], hidden=tuple(cfg["hidden"]),
            minibatches=ppo["minibatches"], fused_update=True,
            learner_dtype=_learner(cfg))
        cc = port.make_chain(cfg["env_id"], total_time_steps=cfg["horizon"])
        init_fn, self.train_step = make_ppo_fused(
            cc, self.B, pc, noise="prng", reward_scale=ppo["reward_scale"],
            device=ctx.device)
        self.state = init_fn(ctx.seed)
        flat = self.state.params.flat()
        self.prog = {"params0": [p.detach().clone() for p in flat]}

        def first_step(opt, args, kwargs):
            if "grad1" not in self.prog:
                self.prog["grad1"] = [
                    opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    / (1 - 0.9) for p in flat]

        hook = self.state.opt.register_step_post_hook(first_step)
        losses = []
        for _ in range(int(tr["checked_iterations"])):
            self.state, metrics = self.train_step(self.state)
            losses.append(metrics["loss"])
        hook.remove()
        self.prog["loss"] = [float(x) for x in losses]
        self.prog["params"] = [p.detach().clone() for p in flat]
        ch, T, B, H = self.ch, self.ch.T, self.B, cfg["hidden"]
        M = T * B
        self.work = M
        self.shape = {
            "bound_ms": {
                "collect": counts.k1_policy_bound(ch.obs_dim, ch.A, ch.N,
                                                  ch.P, H, T, B)[0],
                "update": ppo["epochs"] * counts.k2_bound(
                    ch.obs_dim, ch.A, H, M)[0]},
            "flops": counts.train_flops(ch.obs_dim, ch.A, H, M,
                                        ppo["epochs"])}

    def step(self):
        self.state, _ = self.train_step(self.state)

    def step_spans(self, span):
        st, ts = self.state, self.train_step
        with span("collect"):
            out = ts.collect(st.params, ts.draw_seed(st.gen))
        with span("prepare"):
            _, data = ts.prepare(*out)
        with span("update"):
            ts.update(st.params, st.opt, data, st.gen)

    def release(self):
        self.state = self.train_step = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self):
        return _numbers(self.prog, _reference(self.ctx, False))


def _reference(ctx, tf32: bool):
    with precision(tf32):
        return train(compile_chain(ctx.config["chain"], ctx.config["horizon"]),
                     ctx.config, ctx.seed, int(ctx.traffic["batch"]),
                     int(ctx.traffic["checked_iterations"]), ctx.device)


def build(ctx):
    return Cell(ctx)


def control(ctx):
    """The numbers of a run seeded ``ctx.seed`` with the reference in TF32
    in the program's place."""
    return _numbers(_reference(ctx, True), _reference(ctx, False))
