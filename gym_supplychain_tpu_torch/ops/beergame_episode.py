"""Beer-game episode sweep, rewards only (K6b): CUDA kernel, plain version,
wrapper.

Replaces the TPU kernel ``_episode_kernel`` of
``gym_supplychain_tpu/ops/beergame_pallas.py`` (``beergame_episode_pallas``):
one v0 episode of W weeks for every env from a per-lane demand table
``[W, B]``, an order table ``[W, L, B]`` and a per-lane initial inventory
``[L, B]``, with a constant shipment delay, returning the weekly rewards
``[W, B]``.  All int32.

* ``delay = 0`` delivers into the downstream inventory the same week.
* The shipment ring is ``max(delay, init_delay) + 1`` slots long; slots
  ``1..init_delay`` start with ``init_ship`` in transit (the reference's
  prepended initial delay).

The kernel is the beer-game collect kernel's (``csrc/beergame_collect.cu``)
with its template flag ``EPISODE`` set, a lane per level as
``beergame_block`` plans it: it reads the initial inventory per lane and
writes no observations.  The plain version is the eager
``core/beergame.py`` engine started from that inventory; all arithmetic is
integer, so the two agree bit for bit.  The wrapper takes the plain version
only for tensors on the CPU, and launches the kernel or raises for CUDA
ones.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.beergame import make_beergame_kernels
from ..utils.profiling import count
from . import beergame_collect as _bgc
from .supplychain_collect import _check, resolve_device

__all__ = ["beergame_episode", "launch_beergame_episode",
           "beergame_episode_plain"]


def _ring(delay: int, init_delay):
    """``(init_delay, ring)``; raises for a negative delay."""
    init_delay = delay if init_delay is None else init_delay
    if delay < 0 or init_delay < 0:
        raise ValueError(f"delays must be >= 0 (delay={delay}, "
                         f"init_delay={init_delay})")
    return init_delay, max(delay, init_delay) + 1


def beergame_episode_plain(demand, actions, initial_inventory, delay: int = 2,
                           init_delay=None, init_ship: int = 4,
                           init_orders: int = 4, inv_cost: int = 1,
                           backlog_cost: int = 2) -> torch.Tensor:
    """Plain version on the tensors' device: the eager v0 engine over one
    episode.  Returns the rewards ``[W, B]`` int32."""
    init_delay, ring = _ring(delay, init_delay)
    W, L, B = actions.shape
    device = actions.device
    reset_fn, step_fn, _ = make_beergame_kernels(
        L, W, ring - 1, inv_cost=inv_cost, backlog_cost=backlog_cost,
        itype=torch.int32, device=device)
    delays = torch.full((W + 1,), delay, dtype=torch.int32, device=device)
    delays[0] = init_delay
    st = reset_fn(demand, delays, initial_inventory, init_ship, init_orders, B)
    rew = torch.empty((W, B), dtype=torch.int32, device=device)
    for w in range(W):
        st, (_, r, _) = step_fn(st, actions[w])
        rew[w] = r
    return rew


def launch_beergame_episode(demand, actions, initial_inventory,
                            delay: int = 2, init_delay=None,
                            init_ship: int = 4, init_orders: int = 4,
                            inv_cost: int = 1,
                            backlog_cost: int = 2) -> torch.Tensor:
    """Launch the CUDA episode kernel on the current stream (arguments as
    ``beergame_episode_plain``, contiguous int32 tensors on one card).
    Returns the rewards ``[W, B]`` int32."""
    from ._build import check, library

    init_delay, ring = _ring(delay, init_delay)
    device = actions.device
    if device.type != "cuda":
        raise ValueError("the beer-game episode kernel runs on a CUDA device")
    W, L, B = actions.shape
    if L > _bgc.BG_MAX_L or ring > _bgc.BG_MAX_RING:
        raise NotImplementedError(f"levels {L} and ring {ring} exceed the "
                                  f"kernel's {_bgc.BG_MAX_L} and "
                                  f"{_bgc.BG_MAX_RING}")
    _check(actions, "actions", torch.int32, (W, L, B), device)
    _check(demand, "demand", torch.int32, (W, B), device)
    _check(initial_inventory, "initial_inventory", torch.int32, (L, B),
           device)
    G, E, _ = _bgc.beergame_block(L, B)
    rew = torch.empty((W, B), dtype=torch.int32, device=device)
    code = _bgc.launch_on(
        device, library().bg_episode_launch, W, B, L, ring, delay,
        init_delay, init_ship, init_orders, inv_cost, backlog_cost,
        G.bit_length() - 1, E, demand.data_ptr(), actions.data_ptr(),
        initial_inventory.data_ptr(), rew.data_ptr())
    check(code, "beergame episode")
    count("launch.beergame_episode")
    return rew


def beergame_episode(demand, actions, initial_inventory, delay: int = 2,
                     init_delay=None, init_ship: int = 4, init_orders: int = 4,
                     inv_cost: int = 1, backlog_cost: int = 2,
                     device="cuda") -> torch.Tensor:
    """One beer-game v0 episode for every env on ``device``: ``demand [W,
    B]``, ``actions [W, L, B]`` and ``initial_inventory [L, B]`` (int32) ->
    rewards ``[W, B]`` int32.  ``init_delay`` (default ``delay``) is the
    prepended initial delay that sets how many ring slots start with
    ``init_ship`` in transit.

    Numpy arrays are put on ``device``; tensors on another device are
    rejected.  A CUDA device launches the kernel; the CPU runs the plain
    version.
    """
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    device = resolve_device(device)

    def _on(x, name):
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                   device=device)
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the sweep on {device}")
        return x

    args = (_on(demand, "demand"), _on(actions, "actions"),
            _on(initial_inventory, "initial_inventory"))
    kw = dict(delay=delay, init_delay=init_delay, init_ship=init_ship,
              init_orders=init_orders, inv_cost=inv_cost,
              backlog_cost=backlog_cost)
    if device.type == "cuda":
        return launch_beergame_episode(*args, **kw)
    return beergame_episode_plain(*args, **kw)
