"""Traffic kind ``evaluate``: greedy evaluation episodes.

The program's ``make_fused_evaluator(cc, B, hidden)``: a call draws one
episode's demand and lead-time tables (``device_episode_tables``, Philox
under the key ``(seed, n)``), runs the greedy episode kernel and returns
the statistics of the lanes' returns.  A step of the window is one call,
call i with the key ``(seed mod 2**32, i)``.

The weights are the benchmark's, drawn on the card from the run's seed in
one call: ``w ~ N(0, 1) / sqrt(in)`` for every layer, heads included, so
that the greedy actions spread over (-1, 1), and ``b ~ 0.1 N(0, 1)``.  Both
sides get the same tensors.

Every call's statistics are kept (four numbers); once the window has
closed the plain reference replays ``sampled_calls`` calls drawn from the
run's seed and the last one, and the largest gap of a statistic over the
reference's mean return is compared.

The traced window wraps each call in the span ``evaluate`` and the table
draw inside it, through the evaluator's ``draw_tables`` hook, in the span
``draw``; the evaluate span's own device time is the episode's.
"""
from __future__ import annotations

import gc
import math

import torch

from .. import compare, counts
from ..reference.chain import compile_chain
from ..reference.ppo import precision
from ..reference.rollouts import greedy_returns

RATE, TAIL = "rollout_env_steps_per_s", "rollout_call_ms_p95"
SPANS = ("evaluate", "draw")


def weights(O, A, hidden, seed, device):
    """The flat actor-critic (actor, mu, critic, v, log_std) from one draw
    on ``device``."""
    dims = [O, *hidden]
    shapes = []
    for head in (A, 1):
        shapes += [(n_out, n_in) for n_in, n_out in
                   zip(dims, dims[1:] + [head])]
    n = sum(o * (i + 1) for o, i in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn((n,), generator=gen, device=device)
    flat, off = [], 0
    for o, i in shapes:
        flat.append(z[off:off + o * i].view(o, i) / math.sqrt(i))
        flat.append(z[off + o * i:off + o * (i + 1)].view(o, 1) * 0.1)
        off += o * (i + 1)
    nL = len(hidden)
    actor, critic = flat[:2 * nL + 2], flat[2 * nL + 2:]
    return actor + critic + [torch.full((A, 1), -0.5, device=device)]


def _key(seed: int, n: int):
    """The episode key of call ``n`` of a run seeded ``seed``."""
    return int(seed) % 2 ** 32, n


def _numbers(pairs):
    gap = 0.0
    for prog, ref in pairs:
        scale = abs(ref["mean_return"])
        gap = max(gap, max(abs(float(prog[k]) - ref[k]) / scale
                           for k in ref))
    return {"return_gap": gap}


class Cell:
    def __init__(self, ctx):
        import gym_supplychain_tpu_torch as port
        from gym_supplychain_tpu_torch.learn.evaluate import (
            make_fused_evaluator)
        from gym_supplychain_tpu_torch.rng.device import (
            device_episode_tables)

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.B = ctx, int(tr["batch"])
        self.ch = ch = compile_chain(cfg["chain"], cfg["horizon"])
        cc = port.make_chain(cfg["env_id"], total_time_steps=cfg["horizon"])
        draw = None
        if ctx.spans is not None:
            def draw(ep_key):
                with ctx.spans("draw"):
                    return device_episode_tables(ep_key, cc, self.B,
                                                 device=ctx.device)
        self.evaluate = make_fused_evaluator(cc, self.B, tuple(cfg["hidden"]),
                                             device=ctx.device,
                                             draw_tables=draw)
        self.params = weights(ch.obs_dim, ch.A, cfg["hidden"], ctx.seed,
                              ctx.device)
        self.sample = compare.sampled_calls(ctx.seed, int(tr["sampled_calls"]),
                                            int(tr["sample_within"]))
        self.stats = []
        for i in range(int(tr["warm_calls"])):
            self.evaluate(self.params, _key(ctx.seed ^ 0xFFFFFFFF, i))
        self.work = ch.T * self.B
        H = cfg["hidden"]
        self.shape = {
            "bound_ms": {"evaluate": counts.k4_bound(
                ch.obs_dim, ch.A, ch.N, ch.P, ch.R,
                ch.K if ch.stochastic else 0, H, ch.T, self.B)[0]},
            "flops": counts.eval_flops(ch.obs_dim, ch.A, H, ch.T, self.B)}

    def step(self):
        self.stats.append(self.evaluate(
            self.params, _key(self.ctx.seed, len(self.stats))))

    def step_spans(self, span):
        with span("evaluate"):
            self.step()

    def release(self):
        self.evaluate = None
        gc.collect()

    def check(self):
        last = len(self.stats) - 1
        calls = sorted({n for n in self.sample if n <= last} | {last})
        return _numbers([(self.stats[n], _reference(
            self.ctx, self.ch, self.params, n)) for n in calls])


def _reference(ctx, ch, params, n, tf32=False):
    with precision(tf32):
        return compare.stats(greedy_returns(
            ch, params, _key(ctx.seed, n),
            int(ctx.traffic["batch"]), ctx.device))


def build(ctx):
    return Cell(ctx)


def control(ctx, calls=(0,)):
    """The numbers of a run seeded ``ctx.seed`` with the reference in TF32
    in the program's place, over its calls ``calls``."""
    cfg = ctx.config
    ch = compile_chain(cfg["chain"], cfg["horizon"])
    params = weights(ch.obs_dim, ch.A, cfg["hidden"], ctx.seed, ctx.device)
    return _numbers([(_reference(ctx, ch, params, n, True),
                      _reference(ctx, ch, params, n)) for n in calls])
