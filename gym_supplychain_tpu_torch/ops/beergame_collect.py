"""Beer-game trajectory collection: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``make_beergame_collect_pallas`` of
``gym_supplychain_tpu/ops/beergame_pallas.py`` (``_collect_kernel``) whole:
v0 and v2, a constant or a per-lane delay, modes ``random`` (Philox actions
masked to a power-of-two ``max_order``) and ``actions``.  ``episodes``
back-to-back episodes run in one launch with auto-reset; every week emits
its observation ``obs [S, L, B]`` and reward ``reward [S, B]``, both int32
(S = episodes * weeks).

The kernel (``csrc/beergame_collect.cu``) runs G lanes an env, a lane per
level, with the int32 state in registers, E envs a block, as
``beergame_block`` plans them; it reads the demand and per-lane delay
tables in place through their strides (``table_view``), so a ``[weeks]``
or ``[weeks, B]`` table tiled over episodes is never copied.  All
arithmetic is integer, so it is bit-exact against the plain version, an
eager loop over ``core/beergame.py``.  The wrapper takes the plain version
only for a tensor on the CPU, and launches the kernel or raises for a CUDA
one.  What bounds the kernel on the card is noted in its source.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.beergame import make_beergame_kernels
from ..rng.device import philox_words
from ..utils.profiling import count
from .supplychain_collect import _check, resolve_device, seed_key

__all__ = ["make_beergame_collect", "launch_beergame_collect",
           "beergame_collect_plain", "philox_actions", "beergame_block",
           "launch_on", "table_view", "expand_table"]

_MODES = {"random": 0, "actions": 1}
# the kernel's limits (BG_MAX_L, BG_MAX_RING, BG_MAX_THREADS)
BG_MAX_L, BG_MAX_RING, BG_MAX_THREADS = 16, 16, 256
BG_ENVS = (64, 32, 16, 8)     # envs a block the planner takes, largest first
BG_MIN_BLOCKS = 132           # one block at least on each SM of an H100


@functools.lru_cache(maxsize=None)
def beergame_block(levels: int, B: int, envs=None):
    """``(G, E, blocks)`` of the beer-game kernel for ``levels`` levels and
    B envs: G lanes an env, the power of two at or above ``levels`` and at
    least 4 (a group of 4 lanes shares its Philox calls); E envs
    a block (``envs``, else the largest of ``BG_ENVS`` whose blocks still
    number ``BG_MIN_BLOCKS``, else the smallest), at most
    ``BG_MAX_THREADS`` threads a block; ``blocks`` = ceil(B / E).  Raises
    ``NotImplementedError`` beyond ``BG_MAX_L`` levels."""
    if not 1 <= levels <= BG_MAX_L:
        raise NotImplementedError(f"{levels} levels: the beer-game kernel "
                                  f"takes 1..{BG_MAX_L}")
    G = max(4, 1 << (levels - 1).bit_length())
    if envs is None:
        fits = [E for E in BG_ENVS if G * E <= BG_MAX_THREADS]
        envs = next((E for E in fits if -(-B // E) >= BG_MIN_BLOCKS),
                    fits[-1])
    if envs < 1 or G * envs > BG_MAX_THREADS:
        raise ValueError(f"{envs} envs of {G} lanes exceed "
                         f"{BG_MAX_THREADS} threads a block")
    return G, envs, -(-B // envs)


def launch_on(device, entry, *args):
    """``entry(*args, stream)``: a C launch entry called with the raw
    current stream of the CUDA ``device``, that device current while it
    runs (a launch goes to the current device)."""
    if torch.cuda.current_device() == device.index:
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))


def table_view(x, name: str, weeks: int, S: int, B: int, device):
    """``(x, rows, row stride, lane stride)``: how the kernel reads the
    int32 table ``x``, ``[weeks]`` or ``[weeks, B]`` (tiled over episodes)
    or ``[S]`` or ``[S, B]``, in place, week s from row ``s % rows``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {x.dtype}, expected torch.int32")
    if (x.ndim not in (1, 2) or x.shape[0] not in (weeks, S)
            or x.shape[1:] not in ((), (B,))):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"[{weeks}] or [{S}], with or without {B} lanes")
    return x, x.shape[0], x.stride(0), x.stride(1) if x.ndim == 2 else 0


def expand_table(view, S: int, B: int) -> torch.Tensor:
    """The ``[S, B]`` table the kernel reads through ``view``
    (``table_view``'s), row s = row ``s % rows`` of the strided table."""
    x, rows, row_stride, lane_stride = view
    full = x.as_strided((rows, B), (row_stride, lane_stride))
    return full[torch.arange(S, device=x.device) % rows]


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
    ``beergame_collect_plain``; ``demand`` and ``delays`` may also be
    ``[weeks(, B)]`` or ``[S]``, read in place as ``table_view`` says).
    Returns ``(obs, reward)``."""
    from ._build import check, library

    per_lane, delay, init_delay, max_delay, ring = _resolve(
        delay, init_delay, max_delay)
    if ring > BG_MAX_RING:
        raise NotImplementedError(f"ring {ring} exceeds the kernel's "
                                  f"{BG_MAX_RING}")
    device = demand.device
    if device.type != "cuda":
        raise ValueError("the collect kernel runs on a CUDA device")
    S = episodes * weeks
    dem = table_view(demand, "demand", weeks, S, B, device)
    dls = (table_view(delays, "delays", weeks, S, B, device) if per_lane
           else (None, 1, 0, 0))
    if mode == "actions":
        _check(actions, "actions", torch.int32, (S, levels, B), device)
    elif mode == "random":
        if max_order <= 0 or max_order & (max_order - 1):
            raise ValueError("mode='random' requires power-of-two max_order")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    G, E, _ = beergame_block(levels, B)
    obs = torch.empty((S, levels, B), dtype=torch.int32, device=device)
    rew = torch.empty((S, B), dtype=torch.int32, device=device)
    k0, k1 = seed_key(seed)
    code = launch_on(
        device, library().bg_collect_launch, _MODES[mode], S, B, weeks,
        levels, ring, int(per_lane), 0 if per_lane else int(delay),
        max_delay, init_delay, init_ship, init_orders, init_inv, inv_cost,
        backlog_cost, max_order, int(v2), max_stock,
        exceeded_capacity_penalty, G.bit_length() - 1, E, *dem[1:],
        *dls[1:], dem[0].data_ptr(), dls[0].data_ptr() if per_lane else None,
        actions.data_ptr() if mode == "actions" else None, k0, k1,
        obs.data_ptr(), rew.data_ptr())
    check(code, "beergame collect")
    count("launch.beergame_collect")
    return obs, rew


def make_beergame_collect(weeks: int, levels: int, B: int, episodes: int = 1,
                          mode: str = "random", delay=2, init_delay=None,
                          init_ship: int = 4, init_orders: int = 4,
                          init_inv: int = 12, inv_cost: int = 1,
                          backlog_cost: int = 2, max_order: int = 16,
                          v2: bool = False, max_stock: int = 100,
                          exceeded_capacity_penalty: int = 100,
                          max_delay=None, device="cuda"):
    """Beer-game trajectory collection (v0 and v2), S = episodes * weeks.

    * constant delay: ``run(demand, seed)`` (random) or
      ``run(demand, actions [S, L, B])`` (actions);
    * per-lane delays (``delay=None``, with ``max_delay``):
      ``run(demand, delays, seed)`` or ``run(demand, delays, actions)``,
      ``delays`` [S, B] (or [weeks(, B)], tiled), row t the delay of week
      ``t % weeks + 1``.

    ``demand`` is [weeks]/[weeks, B] (tiled over episodes) or [S]/[S, B].
    Returns ``(obs [S, L, B], reward [S, B])`` int32.  A CUDA device
    launches the kernel, which reads the demand and delay tables in place;
    the CPU runs the plain version on their ``[S, B]`` expansion.  Numpy
    tables are put on ``device`` once and reused while their values stay
    the same; tensors on another device are rejected.
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

    cache = {}

    def _tensor(x, name):
        """A tensor on ``device``; a numpy table is put there once and
        reused while its values stay the same."""
        if isinstance(x, torch.Tensor):
            if x.device != device:
                raise ValueError(f"{name} is on {x.device}, the collector "
                                 f"on {device}")
            return x
        a = np.asarray(x).astype(np.int32, copy=False)
        key = (a.shape, a.tobytes())
        hit = cache.get(name)
        if hit is None or hit[0] != key:
            hit = cache[name] = (key, torch.tensor(a, device=device))
        return hit[1]

    def _go(demand, delays, second):
        tables = dict(demand=_tensor(demand, "demand"))
        if delays is not None:
            tables["delays"] = _tensor(delays, "delays")
        if device.type == "cpu":   # the plain version takes [S, B] tables
            tables = {k: expand_table(table_view(v, k, weeks, S, B, device),
                                      S, B) for k, v in tables.items()}
        args = dict(**tables, **kw)
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
