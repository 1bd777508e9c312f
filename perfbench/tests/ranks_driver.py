"""The driver of the harness's multi-rank tests: no traffic kind, reached
through ``run_cell``'s override ``{"driver": "perfbench.tests.ranks_driver"}``.

Set-up joins the program's process group through its ``parallel/mesh.py``
(gloo on the CPU, NCCL with a card a rank).  A step all-reduces a one on the
rank's device and adds the sum to a running total, so a rank that ran more
steps than another would wait in the all-reduce for ever.  The check
compares the ranks' step counts (``step_spread``: the most less the
fewest) and the total against the world size times the steps
(``sum_gap``), each with the limit 0.

``traffic["fault"]``, ``{"rank": r, "how": "raise" | "hang" | "lag",
"step": n}``, breaks rank r at its step n (the warm steps count): it
raises, sleeps for an hour, or sleeps ``LAG_S`` after the step's
all-reduce, so that it starts its next steps that much later than the
others.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

RATE, TAIL = "rollout_env_steps_per_s", "rollout_call_ms_p95"
SPANS = ("collect",)
LAG_S = 0.5


class Cell:
    def __init__(self, ctx):
        from gym_supplychain_tpu_torch.parallel.mesh import init_distributed

        self.ctx = ctx
        init_distributed(device=ctx.device)
        self.one = torch.ones(1, dtype=torch.int64, device=ctx.device)
        self.total = torch.zeros_like(self.one)
        self.steps = 0
        self.work, self.shape = int(ctx.traffic["batch"]), {}
        for _ in range(int(ctx.traffic["warm_calls"])):
            self.step()

    def step(self):
        fault = self.ctx.traffic.get("fault")
        here = fault and (fault["rank"], fault["step"]) == (self.ctx.rank,
                                                            self.steps)
        if here and fault["how"] == "hang":
            time.sleep(3600)
        if here and fault["how"] == "raise":
            raise RuntimeError(f"rank {self.ctx.rank} fails at step "
                               f"{self.steps}")
        s = self.one.clone()
        dist.all_reduce(s)
        self.total += s
        self.steps += 1
        if here and fault["how"] == "lag":
            time.sleep(LAG_S)

    def step_spans(self, span):
        with span("collect"):
            self.step()

    def release(self):
        pass

    def check(self):
        n = torch.tensor([self.steps, -self.steps], device=self.ctx.device)
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        gap = abs(int(self.total) - self.ctx.world * self.steps)
        dist.destroy_process_group()
        return {"step_spread": float(n[0] + n[1]), "sum_gap": float(gap)}


def build(ctx):
    return Cell(ctx)
