"""Beer-game trajectory collection: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``make_beergame_collect_pallas`` of
``gym_supplychain_tpu/ops/beergame_pallas.py`` (``_collect_kernel``) whole:
v0 and v2, a constant or a per-lane delay, modes ``random`` (Philox actions
masked to a power-of-two ``max_order``) and ``actions``.  ``episodes``
back-to-back episodes run in one launch with auto-reset; every week emits
its observation ``obs [S, L, B]`` and reward ``reward [S, B]``, both int32
(S = episodes * weeks).

The kernel (``csrc/beergame_collect.cu``) runs one thread per env with its
int32 state in per-thread arrays; all arithmetic is integer, so it is
bit-exact against the plain version, an eager loop over
``core/beergame.py``.  The wrapper takes the plain version only for a
tensor on the CPU, and launches the kernel or raises for a CUDA one.  What
bounds the kernel on the card is noted in its source.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.beergame import make_beergame_kernels
from ..rng.device import philox_words
from .supplychain_collect import _check, resolve_device, seed_key

__all__ = ["make_beergame_collect", "launch_beergame_collect",
           "beergame_collect_plain", "philox_actions"]

_MODES = {"random": 0, "actions": 1}


def _resolve(delay, init_delay, max_delay):
    """(per_lane, delay, init_delay, max_delay, ring), as the JAX builder
    sizes them."""
    per_lane = delay is None
    if per_lane:
        if max_delay is None:
            raise ValueError("per-lane delays need max_delay")
        if init_delay is None:
            init_delay = 2              # the reference's prepended delay
    else:
        if init_delay is None:
            init_delay = delay
        max_delay = delay
    return per_lane, delay, init_delay, max_delay, max(max_delay,
                                                       init_delay) + 1


def philox_actions(seed: int, steps, levels: int, max_order: int, B: int,
                   device) -> torch.Tensor:
    """The actions ``random`` mode draws, ``[S, levels, B]`` int32: word l of
    Philox at counter ``(lane, step, l // 4, 0)``, masked to ``max_order``."""
    w = philox_words(seed_key(seed), steps, levels, B, device)
    return (w & (max_order - 1)).to(torch.int32)


def beergame_collect_plain(weeks: int, levels: int, B: int, episodes: int,
                           mode: str, demand, delays=None, actions=None,
                           seed: int = 0, delay=2, init_delay=None,
                           init_ship: int = 4, init_orders: int = 4,
                           init_inv: int = 12, inv_cost: int = 1,
                           backlog_cost: int = 2, max_order: int = 16,
                           v2: bool = False, max_stock: int = 100,
                           exceeded_capacity_penalty: int = 100,
                           max_delay=None):
    """Plain version: an eager loop over ``core/beergame.py``.

    ``demand [S, B]``, per-lane ``delays [S, B]`` (``delay=None``) and, in
    ``actions`` mode, ``actions [S, L, B]``, all int32 on one device.
    Returns ``(obs [S, L, B], reward [S, B])``.
    """
    per_lane, delay, init_delay, max_delay, ring = _resolve(
        delay, init_delay, max_delay)
    device = demand.device
    reset_fn, step_fn, _ = make_beergame_kernels(
        levels, weeks, ring - 1, inv_cost=inv_cost, backlog_cost=backlog_cost,
        exceeded_capacity_penalty=exceeded_capacity_penalty,
        max_stock=max_stock, v2=v2, itype=torch.int32, device=device)
    S = episodes * weeks
    obs = torch.empty((S, levels, B), dtype=torch.int32, device=device)
    rew = torch.empty((S, B), dtype=torch.int32, device=device)
    for e in range(episodes):
        rows = slice(e * weeks, (e + 1) * weeks)
        head = torch.full((1, B), init_delay, dtype=torch.int32, device=device)
        if per_lane:
            dtab = torch.cat([head, delays[rows]])
        else:
            dtab = torch.cat([head, torch.full((weeks, B), delay,
                                               dtype=torch.int32,
                                               device=device)])
        if mode == "random":
            act = philox_actions(seed, range(e * weeks, (e + 1) * weeks),
                                 levels, max_order, B, device)
        else:
            act = actions[rows]
        st = reset_fn(demand[rows], dtab, [init_inv] * levels, init_ship,
                      init_orders, B)
        for w in range(weeks):
            st, (o, r, _) = step_fn(st, act[w])
            obs[e * weeks + w] = o
            rew[e * weeks + w] = r
    return obs, rew


def launch_beergame_collect(weeks: int, levels: int, B: int, episodes: int,
                            mode: str, demand, delays=None, actions=None,
                            seed: int = 0, delay=2, init_delay=None,
                            init_ship: int = 4, init_orders: int = 4,
                            init_inv: int = 12, inv_cost: int = 1,
                            backlog_cost: int = 2, max_order: int = 16,
                            v2: bool = False, max_stock: int = 100,
                            exceeded_capacity_penalty: int = 100,
                            max_delay=None):
    """Launch the CUDA collect kernel on the current stream (arguments as
    ``beergame_collect_plain``).  Returns ``(obs, reward)``."""
    from ._build import check, library

    per_lane, delay, init_delay, max_delay, ring = _resolve(
        delay, init_delay, max_delay)
    device = demand.device
    if device.type != "cuda":
        raise ValueError("the collect kernel runs on a CUDA device")
    S = episodes * weeks
    _check(demand, "demand", torch.int32, (S, B), device)
    if per_lane:
        _check(delays, "delays", torch.int32, (S, B), device)
    if mode == "actions":
        _check(actions, "actions", torch.int32, (S, levels, B), device)
    elif mode == "random":
        if max_order <= 0 or max_order & (max_order - 1):
            raise ValueError("mode='random' requires power-of-two max_order")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    obs = torch.empty((S, levels, B), dtype=torch.int32, device=device)
    rew = torch.empty((S, B), dtype=torch.int32, device=device)
    k0, k1 = seed_key(seed)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.bg_collect_launch(
            _MODES[mode], S, B, weeks, levels, ring, int(per_lane),
            0 if per_lane else int(delay), max_delay, init_delay, init_ship,
            init_orders, init_inv, inv_cost, backlog_cost, max_order, int(v2),
            max_stock, exceeded_capacity_penalty, demand.data_ptr(),
            delays.data_ptr() if per_lane else None,
            actions.data_ptr() if mode == "actions" else None, k0, k1,
            obs.data_ptr(), rew.data_ptr(), stream)
    check(code, "beergame collect")
    launch_beergame_collect.launches += 1
    return obs, rew


launch_beergame_collect.launches = 0


def make_beergame_collect(weeks: int, levels: int, B: int, episodes: int = 1,
                          mode: str = "random", delay=2, init_delay=None,
                          init_ship: int = 4, init_orders: int = 4,
                          init_inv: int = 12, inv_cost: int = 1,
                          backlog_cost: int = 2, max_order: int = 16,
                          v2: bool = False, max_stock: int = 100,
                          exceeded_capacity_penalty: int = 100,
                          max_delay=None, device="cpu"):
    """Beer-game trajectory collection (v0 and v2), S = episodes * weeks.

    * constant delay: ``run(demand, seed)`` (random) or
      ``run(demand, actions [S, L, B])`` (actions);
    * per-lane delays (``delay=None``, with ``max_delay``):
      ``run(demand, delays, seed)`` or ``run(demand, delays, actions)``,
      ``delays`` [S, B] (or [weeks(, B)], tiled), row t the delay of week
      ``t % weeks + 1``.

    ``demand`` is [weeks]/[weeks, B] (tiled over episodes) or [S, B].
    Returns ``(obs [S, L, B], reward [S, B])`` int32.  A CUDA device
    launches the kernel; the CPU runs the plain version.  Numpy tables are
    put on ``device``; tensors on another device are rejected.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "random" and (max_order <= 0 or max_order & (max_order - 1)):
        raise ValueError("mode='random' requires power-of-two max_order")
    per_lane = _resolve(delay, init_delay, max_delay)[0]
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    device = resolve_device(device)
    S = episodes * weeks
    kw = dict(delay=delay, init_delay=init_delay, init_ship=init_ship,
              init_orders=init_orders, init_inv=init_inv, inv_cost=inv_cost,
              backlog_cost=backlog_cost, max_order=max_order, v2=v2,
              max_stock=max_stock,
              exceeded_capacity_penalty=exceeded_capacity_penalty,
              max_delay=max_delay)

    def _tensor(x, name):
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                   device=device)
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the collector on "
                             f"{device}")
        return x

    def _table(x, name, rows):
        """[rows]/[rows, B]/[S(, B)] -> contiguous [S, B] int32."""
        x = _tensor(x, name)
        if x.ndim == 1:
            x = x[:, None].expand(x.shape[0], B)
        if x.shape[0] == rows and rows != S:
            x = x.repeat(episodes, 1)
        return x.contiguous()

    def _go(demand, delays, second):
        demand = _table(demand, "demand", weeks)
        if delays is not None:
            delays = _table(delays, "delays", weeks)
        args = dict(demand=demand, delays=delays, **kw)
        if mode == "random":
            args["seed"] = int(second)
        else:
            args["actions"] = _tensor(second, "actions")
        if device.type == "cuda":
            return launch_beergame_collect(weeks, levels, B, episodes, mode,
                                           **args)
        return beergame_collect_plain(weeks, levels, B, episodes, mode,
                                      **args)

    if per_lane:
        def run(demand, delays, second):
            return _go(demand, delays, second)
    else:
        def run(demand, second):
            return _go(demand, None, second)
    return run
