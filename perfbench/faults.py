"""Faults planted in the program under a run, to show that ``correct``
catches them.

``plant(kind, fault)`` is a context manager that breaks the program's
timed path for a traffic kind while the cell is built and run:

* ``unchanged``: a step that returns its state unchanged: the trainer's
  optimizer steps with a zero learning rate; the env's plain step (the
  program's path on the CPU) hands back the state it got;
* ``half``: half of the batch left out, the mean taken over the rest: the
  update's data cut to the first half of the lanes; the collection's
  second half of the lanes replaced by the first; the evaluator's
  statistics over the first half;
* ``altered``: an answer altered where it is produced: one observation of
  each collection call moved by 0.25; one lane's return of each
  evaluation scaled by 1.1.

The exchange between chips does not exist in these one-chip cells.
"""
from __future__ import annotations

import contextlib

FAULTS = {"train": ("unchanged", "half"),
          "collect": ("unchanged", "half", "altered"),
          "evaluate": ("unchanged", "half", "altered")}


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _frozen_step(make_kernels):
    def make(*args, **kw):
        reset_fn, step_fn, obs_fn = make_kernels(*args, **kw)

        def step(state, action):
            _, out = step_fn(state, action)
            return state, out

        return reset_fn, step, obs_fn
    return make


def plant(kind: str, fault: str):
    """The context manager that plants ``fault`` for traffic ``kind``."""
    import torch
    from gym_supplychain_tpu_torch.learn import evaluate, ppo
    from gym_supplychain_tpu_torch.ops import (supplychain_collect,
                                               supplychain_episode)

    if fault not in FAULTS[kind]:
        raise ValueError(f"{kind} cells have no fault {fault!r}")
    if kind == "train" and fault == "unchanged":
        def adam(params, cfg):
            return torch.optim.Adam(params.parameters(), lr=0.0)
        return _patched(ppo, "_adam", adam)
    if kind == "train":
        make_update = ppo._make_update

        def half(*args, **kw):
            update = make_update(*args, **kw)

            def run(params, opt, data, generator=None):
                B = data[0].shape[-1]
                return update(params, opt,
                              tuple(d[..., :B // 2] for d in data), generator)
            return run
        return _patched(ppo, "_make_update", half)
    if fault == "unchanged":
        mod = supplychain_collect if kind == "collect" else supplychain_episode
        return _patched(mod, "make_supplychain_kernels",
                        _frozen_step(mod.make_supplychain_kernels))
    if kind == "collect":
        make = supplychain_collect.make_supplychain_collect

        def broken(*args, **kw):
            run = make(*args, **kw)

            def call(seed):
                obs, rew = run(seed)
                if fault == "half":
                    B = obs.shape[-1]
                    obs[..., B - B // 2:] = obs[..., :B // 2]
                    rew[..., B - B // 2:] = rew[..., :B // 2]
                else:
                    obs[0, 0, 0] += 0.25
                return obs, rew
            return call
        return _patched(supplychain_collect, "make_supplychain_collect",
                        broken)
    stats = evaluate._stats

    def broken_stats(per_env):
        if fault == "half":
            return stats(per_env[:, :per_env.shape[1] // 2])
        per_env = per_env.clone()
        per_env[:, 0] *= 1.1
        return stats(per_env)
    return _patched(evaluate, "_stats", broken_stats)
