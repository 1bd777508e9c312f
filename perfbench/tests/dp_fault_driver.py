"""The ``train_dp`` driver with a fault planted in its ranks.  The
traffic's ``fault`` names it: ``all_reduce`` (the default), the gradients'
all-reduce over the data group skipped, so each rank steps on its own
lanes' gradients; or a fault of ``perfbench/faults.py``'s ``train`` kind
(``unchanged``, ``half``), planted for the rank's life.  No traffic kind;
``test_perfbench_dp.py`` reaches it through ``launch``'s override
``{"driver": "perfbench.tests.dp_fault_driver"}``."""
from __future__ import annotations

import contextlib

from perfbench import faults
from perfbench.drivers import train_dp
from perfbench.drivers.train_dp import RATE, SPANS, TAIL  # noqa: F401

_LIFE = contextlib.ExitStack()      # holds a planted fault for the rank's life


def build(ctx):
    from gym_supplychain_tpu_torch.learn import ppo

    fault = ctx.traffic.get("fault", "all_reduce")
    if fault == "all_reduce":
        ppo._mean_grads_ = lambda mesh, leaves, loss: loss
    else:
        _LIFE.enter_context(faults.plant("train", fault))
    return train_dp.build(ctx)
