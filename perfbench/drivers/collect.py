"""Traffic kind ``collect``: whole episodes of random actions.

The program's ``make_supplychain_collect(cc, T, B, mode="random")``: one
episode of every lane a call, the demand, lead-time and action rows drawn
in the kernel under the call's 64-bit seed, every observation and reward
out.  A step of the window is one call, with the seed
``compare.call_seed(seed, i)`` for call i.

The outputs of ``sampled_calls`` calls drawn from the run's seed, and of
the window's last call, are kept; once the window has closed the plain
reference replays each from its seed, and the largest observation gap and
the largest reward gap over the largest reward are compared.
"""
from __future__ import annotations

import gc

import torch

from .. import compare, counts
from ..reference.chain import compile_chain
from ..reference.rollouts import collect_random

RATE, TAIL = "rollout_env_steps_per_s", "rollout_call_ms_p95"
SPANS = ("collect",)


def _numbers(pairs):
    obs_gap = rew_gap = 0.0
    for (obs, rew), (ref_obs, ref_rew) in pairs:
        obs_gap = max(obs_gap, compare.max_abs_gap(obs, ref_obs))
        scale = float(ref_rew.abs().max())
        rew_gap = max(rew_gap, compare.max_abs_gap(rew, ref_rew) / scale)
    return {"obs_gap": obs_gap, "reward_gap": rew_gap}


class Cell:
    def __init__(self, ctx):
        import gym_supplychain_tpu_torch as port
        from gym_supplychain_tpu_torch.ops.supplychain_collect import (
            make_supplychain_collect)

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.B = ctx, int(tr["batch"])
        self.ch = ch = compile_chain(cfg["chain"], cfg["horizon"])
        cc = port.make_chain(cfg["env_id"], total_time_steps=cfg["horizon"])
        self.run = make_supplychain_collect(cc, ch.T, self.B, mode="random",
                                            device=ctx.device)
        self.sample = compare.sampled_calls(ctx.seed, int(tr["sampled_calls"]),
                                            int(tr["sample_within"]))
        self.kept, self.n = {}, 0
        for i in range(int(tr["warm_calls"])):
            self.run(compare.call_seed(ctx.seed, -1 - i))
        self.work = ch.T * self.B
        self.shape = {"bound_ms": {"collect": counts.collect_bound(
            ch.obs_dim, ch.N, ch.P, ch.T, self.B)[0]}}

    def step(self):
        seed = compare.call_seed(self.ctx.seed, self.n)
        out = self.run(seed)
        if self.n in self.sample:
            self.kept[self.n] = (seed, out)
        self.last = (self.n, seed, out)
        self.n += 1

    def step_spans(self, span):
        with span("collect"):
            self.step()

    def release(self):
        n, seed, out = self.last
        self.kept[n] = (seed, out)
        self.run = self.last = None
        gc.collect()

    def check(self):
        pairs = []
        for seed, out in self.kept.values():
            pairs.append((out, collect_random(self.ch, seed, self.B,
                                              self.ctx.device)))
        return _numbers(pairs)


def build(ctx):
    return Cell(ctx)


def control(ctx, calls=(0,)):
    """The numbers of a run seeded ``ctx.seed`` with the reference in
    bfloat16 in the program's place, over its calls ``calls``."""
    ch = compile_chain(ctx.config["chain"], ctx.config["horizon"])
    B, dev = int(ctx.traffic["batch"]), ctx.device
    seeds = [compare.call_seed(ctx.seed, n) for n in calls]
    return _numbers([(collect_random(ch, s, B, dev, torch.bfloat16),
                      collect_random(ch, s, B, dev)) for s in seeds])
