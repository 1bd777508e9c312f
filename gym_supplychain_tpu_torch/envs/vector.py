"""Batched environments with auto-reset: thousands of lockstep envs.

The counterpart of ``gym_supplychain_tpu/envs/vector.py`` in its device
mode.  All tensors keep the env batch as the trailing axis.  Episodes are
fixed-length, so the whole batch shares one clock and auto-reset happens for
every lane at once: the terminal observation of the finished episode is
replaced by the first observation of the next one, and ``done`` still flags
the boundary.

Random streams are Philox keyed ``(seed, n)``: ``n`` counts the episodes (or
the resets) drawn so far, so consecutive episodes play fresh streams and a
seed reproduces them on the CPU and the card alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.compile import CompiledChain, compile_chain
from ..core.step import EnvState, StepOutput, make_supplychain_kernels
from ..rng.device import philox_uniform

__all__ = ["VecState", "make_vec_env", "VecSupplyChainEnv",
           "beergame_table_config", "make_beergame_table_draw",
           "VecBeerGameEnv"]


class VecState(NamedTuple):
    key: Tuple[int, int]    # (seed, n): the Philox key of the next episode
    env: EnvState


def _as_key(key) -> Tuple[int, int]:
    if isinstance(key, (int, np.integer)):
        return int(key), 0
    return int(key[0]), int(key[1])


def _split(key):
    """(next key, key of this episode)."""
    seed, n = key
    return (seed, n + 1), (seed, n)


def make_vec_env(cc: CompiledChain, batch_size: int, dtype=torch.float32,
                 device="cuda"):
    """Functional batched env over a compiled chain.

    Returns ``(init_fn, step_fn, obs_fn)``: ``init_fn(key) -> VecState``
    (``key`` a seed or a ``(seed, n)`` pair) and
    ``step_fn(state, action[A, B]) -> (VecState, StepOutput)`` with batched
    auto-reset.  Each step draws its demand and lead-time rows from the
    episode's Philox key (the JAX package's ``rng='stateless'``; its
    whole-episode ``'table'`` mode is not ported).
    """
    B = batch_size
    reset_k, step_k, obs_k = make_supplychain_kernels(
        cc, dtype=dtype, stateless_rng=True, device=device)

    def init_fn(key) -> VecState:
        key, sub = _split(_as_key(key))
        return VecState(key=key, env=reset_k(sub, B))

    def obs_fn(state: VecState):
        return obs_k(state.env)

    def step_fn(state: VecState, action) -> Tuple[VecState, StepOutput]:
        env, out = step_k(state.env, action)
        key = state.key
        if out.done:
            key, sub = _split(key)
            env = reset_k(sub, B)
            out = out._replace(obs=obs_k(env))
        return VecState(key=key, env=env), out

    return init_fn, step_fn, obs_fn


class VecSupplyChainEnv:
    """Object-style wrapper over the functional batched API: the JAX
    package's device mode, the episode streams drawn by the engine itself
    (its host MT19937 modes are not ported)."""

    def __init__(self, nodes_info=None, batch_size: int = 1024, cc=None,
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 **env_kwargs):
        if cc is None:
            cc = compile_chain(nodes_info, **env_kwargs)
        self.cc = cc
        self.B = batch_size
        self.dtype = dtype
        self._init_fn, self._step_fn, self._obs_fn = make_vec_env(
            cc, batch_size, dtype, device=device)
        self._key = (int(seed), 0)
        self.state: Optional[VecState] = None

    def reset(self):
        """Start fresh episodes; consecutive resets continue the stream."""
        if self.state is not None:
            self._key = self.state.key
        self.state = self._init_fn(self._key)
        return self._obs_fn(self.state)

    def step(self, action) -> StepOutput:
        self.state, out = self._step_fn(self.state, action)
        return out

    @property
    def action_shape(self):
        return (self.cc.A, self.B)


def _is_range(x):
    """The reference's stochastic-range dispatch: a 2-element tuple/list is
    a ``randint(low, high)`` range, high exclusive."""
    return isinstance(x, tuple) or (isinstance(x, list) and len(x) == 2)


def beergame_table_config(weeks: int, customer_demand, shipment_delays,
                          device="cuda") -> dict:
    """The beer game's episode tables as the JAX package's beer-game
    trainer, evaluator and baseline read their arguments: a
    2-element tuple (or list) is a ``randint(low, high)`` range drawn per
    lane and episode; otherwise ``customer_demand`` is a scripted table
    (default 4 for 4 weeks, then 8; its length sets the weeks) and
    ``shipment_delays`` a constant delay, with the prepended initial delay
    2.  Returns ``weeks``, ``max_delay`` (the ring's bound, at least 2),
    ``max_demand`` (for the observation scale) and ``draw``, the int32
    ``make_beergame_table_draw`` of these tables on ``device``."""
    dem_range = customer_demand if _is_range(customer_demand) else None
    delay_range = shipment_delays if _is_range(shipment_delays) else None
    demand = delays = None
    if dem_range is None:
        demand = np.asarray(customer_demand if customer_demand is not None
                            else [4] * 4 + [8] * (weeks - 4), np.int32)
        weeks = len(demand)
    if delay_range is None:
        delays = np.full(weeks + 1, shipment_delays, np.int32)
        delays[0] = 2
        max_delay = int(delays.max())
    else:
        max_delay = max(2, int(delay_range[1]))
    max_demand = (float(demand.max()) if demand is not None
                  else float(dem_range[1] - 1))
    draw = make_beergame_table_draw(weeks, dem_range, delay_range, demand,
                                    delays, torch.int32, device)
    return dict(weeks=weeks, max_delay=max_delay, max_demand=max_demand,
                draw=draw)


def make_beergame_table_draw(weeks: int, dem_range=None, delay_range=None,
                             scripted_demand=None, scripted_delays=None,
                             itype=torch.int32, device="cuda"):
    """Per-lane episode tables for the stochastic beer game v2.

    Returns ``draw(key, B) -> (demand [weeks, B], delays [weeks+1, B])``.
    Stochastic fields are uniform integers in ``[low, high)`` per lane and
    week, ``floor(u * (high - low)) + low`` from Philox (row 0 demand, row 1
    delay, at counter ``(lane, week, 0, 0)``); scripted fields broadcast.
    Delay slot 0 is the prepended initial delay 2.
    """
    device = torch.device(device)

    def _randint(u, rng):
        lo, hi = int(rng[0]), int(rng[1])
        return (torch.floor(u * (hi - lo)) + lo).to(itype)

    def draw(key, B: int):
        u = philox_uniform(_as_key(key), range(weeks), 2, B, device)
        if dem_range is not None:
            demand = _randint(u[:, 0], dem_range)
        else:
            demand = torch.as_tensor(np.asarray(scripted_demand), dtype=itype,
                                     device=device)[:, None].expand(weeks, B)
        if delay_range is not None:
            delays = torch.cat([torch.full((1, B), 2, dtype=itype,
                                           device=device),
                                _randint(u[:, 1], delay_range)], dim=0)
        else:
            delays = torch.as_tensor(np.asarray(scripted_delays), dtype=itype,
                                     device=device)[:, None].expand(weeks + 1, B)
        return demand, delays

    return draw


class VecBeerGameEnv:
    """Batched beer game (v0 semantics by default, v2 via flags), the JAX
    package's device mode: stochastic 2-element ranges for
    ``customer_demand`` or ``shipment_delays`` draw fresh per-lane tables at
    every reset (its host MT19937 mode is not ported)."""

    def __init__(self, batch_size: int = 1024, levels: int = 4,
                 customer_demand=None, shipment_delays: int = 2,
                 initial_inventory: int = 12, inv_cost=1, backlog_cost=2,
                 initial_shipment: int = 4, initial_orders: int = 4,
                 v2: bool = False, max_stock: int = 100,
                 exceeded_capacity_penalty: int = 100, seed: int = 0,
                 weeks: int = 35, itype=torch.int32, device="cuda"):
        from ..core.beergame import make_beergame_kernels

        self.B = batch_size
        self.levels = levels
        if customer_demand is None:
            customer_demand = [4] * 4 + [8] * 31
        self._dem_range = customer_demand if _is_range(customer_demand) else None
        self._delay_range = (shipment_delays if _is_range(shipment_delays)
                             else None)
        if self._dem_range is not None:
            self.max_weeks = weeks
            self._demand = None
        else:
            self._demand = np.asarray(customer_demand, int)
            self.max_weeks = len(self._demand)
        if self._delay_range is not None:
            self._delays = None
            max_delay = max(2, int(self._delay_range[1]))
        elif isinstance(shipment_delays, int):
            self._delays = np.full(self.max_weeks + 1, shipment_delays, int)
            self._delays[0] = 2
            max_delay = int(self._delays.max())
        else:
            self._delays = np.insert(np.asarray(shipment_delays, int), 0, 2)
            max_delay = int(self._delays.max())
        self._inv0 = np.full(levels, initial_inventory, int)
        self._ship0 = initial_shipment
        self._orders0 = initial_orders
        self._reset_fn, self._step_fn, self._obs_fn = make_beergame_kernels(
            levels, self.max_weeks, max_delay, inv_cost=inv_cost,
            backlog_cost=backlog_cost, max_stock=max_stock,
            exceeded_capacity_penalty=exceeded_capacity_penalty, v2=v2,
            itype=itype, device=device)
        self._stochastic = (self._dem_range is not None
                            or self._delay_range is not None)
        if self._stochastic:
            self._draw = make_beergame_table_draw(
                self.max_weeks, self._dem_range, self._delay_range,
                self._demand, self._delays, itype, device)
        self._key = (int(seed), 0)
        self._t = 0
        self.state = None

    def reset(self):
        self._t = 0
        if self._stochastic:
            self._key, sub = _split(self._key)
            demand, delays = self._draw(sub, self.B)
        else:
            demand, delays = self._demand, self._delays
        self.state = self._reset_fn(demand, delays, self._inv0, self._ship0,
                                    self._orders0, self.B)
        return self._obs_fn(self.state)

    def step(self, action):
        """action [levels, B] int -> (obs [levels, B], reward [B], done);
        the terminal week's obs is replaced by a fresh episode's first."""
        self.state, (obs, reward, done) = self._step_fn(self.state, action)
        self._t += 1
        if self._t >= self.max_weeks:
            obs = self.reset()
        return obs, reward, done
