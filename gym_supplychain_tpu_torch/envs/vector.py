"""Batched environments with auto-reset: thousands of lockstep envs.

The counterpart of ``gym_supplychain_tpu/envs/vector.py``.  All tensors
keep the env batch as the trailing axis.  Episodes are fixed-length, so the
whole batch shares one clock and auto-reset happens for every lane at once:
the terminal observation of the finished episode is replaced by the first
observation of the next one, and ``done`` still flags the boundary.

Two kinds of random streams feed them:

* device streams (the default): Philox keyed ``(seed, n)``, where ``n``
  counts the episodes (or the resets) drawn so far, so consecutive episodes
  play fresh streams and a seed reproduces them on the CPU and the card
  alike;
* host streams (``rng_mode="host"`` / ``"host-lanes"``): the reference's
  MT19937 streams (``rng/host.py``), whole-episode tables drawn on the host
  at every episode boundary and put on the env's device once an episode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.compile import CompiledChain, compile_chain
from ..core.step import EnvState, StepOutput, make_supplychain_kernels
from ..rng.device import device_episode_tables, philox_uniform
from ..rng.host import BatchHostRNG, HostEpisodeRNG

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
                 rng: str = "stateless", device="cuda", lane0: int = 0):
    """Functional batched env over a compiled chain.

    Returns ``(init_fn, step_fn, obs_fn)``: ``init_fn(key) -> VecState``
    (``key`` a seed or a ``(seed, n)`` pair) and
    ``step_fn(state, action[A, B]) -> (VecState, StepOutput)`` with batched
    auto-reset.  ``rng="stateless"`` (the default) draws each step's demand
    and lead-time rows from the episode's Philox key; ``rng="table"`` draws
    whole-episode tables at every reset (``device_episode_tables``, whose
    rows are the stateless rows of the same key, so the two modes play the
    same episodes).  ``lane0`` is the global index of the first lane: a
    process holding lanes ``lane0 .. lane0 + B - 1`` of a larger batch
    plays what those lanes play in one process.
    """
    if rng not in ("stateless", "table"):
        raise ValueError(f"rng {rng!r}: 'stateless' or 'table'")
    B = batch_size
    stateless = rng == "stateless"
    reset_k, step_k, obs_k = make_supplychain_kernels(
        cc, dtype=dtype, stateless_rng=stateless, device=device, lane0=lane0)

    def _fresh(key) -> EnvState:
        if stateless:
            return reset_k(key, B)
        return reset_k(*device_episode_tables(key, cc, B, dtype, device,
                                              lane0), B)

    def init_fn(key) -> VecState:
        key, sub = _split(_as_key(key))
        return VecState(key=key, env=_fresh(sub))

    def obs_fn(state: VecState):
        return obs_k(state.env)

    def step_fn(state: VecState, action) -> Tuple[VecState, StepOutput]:
        env, out = step_k(state.env, action)
        key = state.key
        if out.done:
            key, sub = _split(key)
            env = _fresh(sub)
            out = out._replace(obs=obs_k(env))
        return VecState(key=key, env=env), out

    return init_fn, step_fn, obs_fn


class VecSupplyChainEnv:
    """Object-style wrapper over the functional batched API.

    ``rng_mode="device"`` (the default) draws the episode streams on the
    env's device (Philox); ``rng_mode="host"`` uses the MT19937 parity
    generator (each batch lane plays consecutive episodes of the single-env
    reference stream seeded ``seed``); ``rng_mode="host-lanes"`` gives each
    lane its own MT19937 stream seeded ``seed + lane`` (B independent
    reference envs), drawn by the native multithreaded batch generator when
    it builds (``lane_rng.backend``).  The host modes step the table-mode
    engine and draw the next episode's tables at each boundary; the tables
    reach the device once an episode.
    """

    def __init__(self, nodes_info=None, batch_size: int = 1024, cc=None,
                 dtype=torch.float32, rng_mode: str = "device", seed: int = 0,
                 device="cuda", **env_kwargs):
        if rng_mode not in ("device", "host", "host-lanes"):
            raise ValueError(f"rng_mode {rng_mode!r}: 'device', 'host' or "
                             "'host-lanes'")
        if cc is None:
            cc = compile_chain(nodes_info, **env_kwargs)
        self.cc = cc
        self.B = batch_size
        self.dtype = dtype
        self.rng_mode = rng_mode
        self._key = (int(seed), 0)
        self.state: Optional[VecState] = None
        if rng_mode == "device":
            self._init_fn, self._step_fn, self._obs_fn = make_vec_env(
                cc, batch_size, dtype, device=device)
            return
        # the host modes step without the engine's auto-reset, so that each
        # boundary draws the next tables from the MT19937 streams; episodes
        # are fixed-length, so the boundary is the shared clock's
        self._reset_k, self._step_k, self._obs_k = make_supplychain_kernels(
            cc, dtype=dtype, device=device)
        if rng_mode == "host":
            self._host_rng = HostEpisodeRNG(cc, seed)
        else:
            self.lane_rng = BatchHostRNG(cc, [seed + b for b in range(self.B)])

    def reset(self):
        """Start fresh episodes; consecutive resets continue the streams
        (in the host modes, exactly like consecutive reference episodes)."""
        if self.rng_mode == "device":
            if self.state is not None:
                self._key = self.state.key
            self.state = self._init_fn(self._key)
            return self._obs_fn(self.state)
        if self.rng_mode == "host-lanes":
            demands, leadtimes = self.lane_rng.episode_tables()
        else:
            demands, leadtimes = self._host_rng.batch_tables(self.B)
        self.state = VecState(key=self._key,
                              env=self._reset_k(demands, leadtimes, self.B))
        return self._obs_k(self.state.env)

    def step(self, action) -> StepOutput:
        if self.rng_mode == "device":
            self.state, out = self._step_fn(self.state, action)
            return out
        env, out = self._step_k(self.state.env, action)
        self.state = self.state._replace(env=env)
        if out.done:
            out = out._replace(obs=self.reset())
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

    Returns ``draw(key, B, lane0=0) -> (demand [weeks, B], delays
    [weeks+1, B])``.  Stochastic fields are uniform integers in ``[low,
    high)`` per lane and week, ``floor(u * (high - low)) + low`` from Philox
    (row 0 demand, row 1 delay, at counter ``(lane, week, 0, 0)``, the lane
    counted from ``lane0``: a rank holding lanes ``lane0 ..`` of a larger
    batch draws their tables); scripted fields broadcast.  Delay slot 0 is
    the prepended initial delay 2.
    """
    device = torch.device(device)

    def _randint(u, rng):
        lo, hi = int(rng[0]), int(rng[1])
        return (torch.floor(u * (hi - lo)) + lo).to(itype)

    def draw(key, B: int, lane0: int = 0):
        u = philox_uniform(_as_key(key), range(weeks), 2, B, device,
                           lane0=lane0)
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
    """Batched beer game (v0 semantics by default, v2 via flags).

    Lockstep batch; actions are ``[levels, B]`` ints.  ``customer_demand``
    and ``shipment_delays`` accept the reference v2's stochastic 2-element
    ranges: fresh per-lane tables are then drawn at every reset.
    ``rng_mode="device"`` draws them from Philox (``make_beergame_table_draw``);
    ``rng_mode="host"`` gives each lane its own MT19937 stream seeded
    ``seed + lane`` with the reference's draw order (demand first, then
    delays, per reset), so lane b is bit-exact with a single
    ``BeerGameEnv2(seed=seed + b)`` across consecutive episodes.
    """

    def __init__(self, batch_size: int = 1024, levels: int = 4,
                 customer_demand=None, shipment_delays: int = 2,
                 initial_inventory: int = 12, inv_cost=1, backlog_cost=2,
                 initial_shipment: int = 4, initial_orders: int = 4,
                 v2: bool = False, max_stock: int = 100,
                 exceeded_capacity_penalty: int = 100, seed: int = 0,
                 rng_mode: str = "device", weeks: int = 35,
                 itype=torch.int32, device="cuda"):
        from ..core.beergame import make_beergame_kernels

        if rng_mode not in ("device", "host"):
            raise ValueError(f"rng_mode {rng_mode!r}: 'device' or 'host'")
        self.B = batch_size
        self.levels = levels
        self.rng_mode = rng_mode
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
        if self._stochastic and rng_mode == "device":
            self._draw = make_beergame_table_draw(
                self.max_weeks, self._dem_range, self._delay_range,
                self._demand, self._delays, itype, device)
        if self._stochastic and rng_mode == "host":
            self._lane_rs = [np.random.RandomState(seed + b)
                             for b in range(self.B)]
        self._key = (int(seed), 0)
        self._t = 0
        self.state = None

    def _host_tables(self):
        """Per-lane MT19937 tables, the reference's draw order per reset
        (demand before delays): ``(demand [weeks, B], delays [weeks+1, B])``."""
        dem_cols, delay_cols = [], []
        for rs in self._lane_rs:
            if self._dem_range is not None:
                dem_cols.append(rs.randint(self._dem_range[0],
                                           self._dem_range[1],
                                           size=self.max_weeks))
            else:
                dem_cols.append(self._demand)
            if self._delay_range is not None:
                d = rs.randint(self._delay_range[0], self._delay_range[1],
                               size=self.max_weeks)
                delay_cols.append(np.insert(d, 0, 2))
            else:
                delay_cols.append(self._delays)
        return np.stack(dem_cols, -1), np.stack(delay_cols, -1)

    def reset(self):
        self._t = 0
        if not self._stochastic:
            demand, delays = self._demand, self._delays
        elif self.rng_mode == "host":
            demand, delays = self._host_tables()
        else:
            self._key, sub = _split(self._key)
            demand, delays = self._draw(sub, self.B)
        self.state = self._reset_fn(demand, delays, self._inv0, self._ship0,
                                    self._orders0, self.B)
        return self._obs_fn(self.state)

    @property
    def customer_demand(self):
        """This episode's demand table ``[weeks, B]``."""
        return self.state.customer_demand

    @property
    def shipment_delays(self):
        """This episode's delays ``[weeks + 1, B]`` (slot 0 the initial
        delay)."""
        return self.state.shipment_delays

    def step(self, action):
        """action [levels, B] int -> (obs [levels, B], reward [B], done);
        the terminal week's obs is replaced by a fresh episode's first."""
        self.state, (obs, reward, done) = self._step_fn(self.state, action)
        self._t += 1
        if self._t >= self.max_weeks:
            obs = self.reset()
        return obs, reward, done
