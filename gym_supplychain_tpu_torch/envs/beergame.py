"""Single-env Beer Game wrappers (v0 classic, v2 revised) over the batched
step engine of ``core/beergame.py``.

The counterpart of ``gym_supplychain_tpu/envs/beergame.py``: constructor
schemas and step/reset/seed/render protocols mirror the reference
``BeerGameEnv`` (beergame_env.py:6-181) and ``BeerGameEnv2``
(beergame2_env.py:5-211), including v0's absence of declared action /
observation spaces (beergame_env.py:62-64), v2's MultiDiscrete spaces and
its MT19937 draws of stochastic demand and delays at every reset
(demand first, then delays).  The engine runs int64 at B = 1, on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.beergame import make_beergame_kernels
from ..rng.gym_compat import old_gym_np_random
from .strict_obs import to_host

__all__ = ["BeerGameEnv", "BeerGameEnv2", "OldGymMultiDiscrete"]


class OldGymMultiDiscrete:
    """MultiDiscrete space with the classic gym sampling stream
    (``(np_random.random_sample(nvec.shape) * nvec).astype(int64)``)."""

    def __init__(self, nvec):
        self.nvec = np.asarray(nvec, np.int64)
        self.shape = self.nvec.shape
        self.np_random = old_gym_np_random(None)

    def seed(self, seed=None):
        self.np_random = old_gym_np_random(seed)

    def sample(self):
        return (self.np_random.random_sample(self.nvec.shape)
                * self.nvec).astype(np.int64)

    def contains(self, x):
        x = np.asarray(x)
        return x.shape == self.shape and bool(((x >= 0) & (x < self.nvec)).all())


class _BeerGameBase:
    """The engine, the protocol and the state accessors both games share."""

    def _build(self, max_delay, device, **kw):
        self.device = torch.device(device)
        self._reset_fn, self._step_fn, self._obs_fn = make_beergame_kernels(
            self.levels, self.max_weeks, max_delay, inv_cost=self.inv_cost,
            backlog_cost=self.backlog_cost, itype=torch.int64,
            device=self.device, **kw)

    def _reset_state(self):
        self.state = self._reset_fn(
            self.customer_demand, self.shipment_delays, self.initial_inventory,
            self.initial_shipment_value, self.initial_orders_value, 1)
        self.current_state = to_host(self._obs_fn(self.state))[:, 0]
        return self.current_state

    def step(self, action):
        a = torch.as_tensor(np.asarray(action, dtype=np.int64)
                            .reshape(self.levels, 1), device=self.device)
        self.state, (obs, reward, done) = self._step_fn(self.state, a)
        self.current_state = to_host(obs)[:, 0]
        return self.current_state, int(reward[0]), bool(done), {}

    @property
    def week(self):
        return self.state.week

    @property
    def inventory(self):
        return to_host(self.state.inventory)[:, 0]

    @property
    def backlog(self):
        return to_host(self.state.backlog)[:, 0]

    def close(self):
        pass


class BeerGameEnv(_BeerGameBase):
    """Classic 4-echelon MIT Beer Game (reference beergame_env.py:6-181)."""

    def __init__(self, env_init_info={}, device="cuda"):
        self.DEBUG = False
        std_levels = 4
        std_demands = [4] * 4 + [8] * 31
        self.levels = env_init_info.get('levels', std_levels)
        self.inv_cost = env_init_info.get('inv_cost', 1)
        self.backlog_cost = env_init_info.get('backlog_cost', 2)
        self.customer_demand = np.asarray(
            env_init_info.get('customer_demand', std_demands), dtype=int)
        self.initial_inventory = np.asarray(
            env_init_info.get('initial_inventory', 12 + np.zeros(self.levels)),
            dtype=int)
        self.max_weeks = len(self.customer_demand)
        # slot 0 is a prepended default delay (beergame_env.py:39)
        self.shipment_delays = np.asarray(
            [2] + env_init_info.get('shipment_delays', [2] * self.max_weeks))
        self.initial_shipment_value = env_init_info.get('initial_shipment_value', 4)
        self.initial_orders_value = env_init_info.get('initial_orders_value', 4)
        self._build(int(self.shipment_delays.max()), device)
        self.current_state = None

    def reset(self):
        return self._reset_state()

    def render(self, mode='human'):
        print('\n' + '=' * 20)
        print('Week:\t', self.week)
        inv, back = self.inventory, self.backlog
        print('Inventory:\t', inv, back, inv - back)
        print('Incoming order:\t', to_host(self.state.incoming_orders)[:, 0])
        print('Orders placed:\t', to_host(self.state.orders_placed)[:, 0])
        if self.week < self.max_weeks:
            print('Next customer demand:\t', self.customer_demand[self.week])


class BeerGameEnv2(_BeerGameBase):
    """Revised beer game: MultiDiscrete spaces, capacity penalty, optional
    stochastic demand/delay ranges (reference beergame2_env.py:5-211)."""

    def __init__(self, max_stock=100, max_order=30, weeks=35, levels=4,
                 customer_demand=[4] * 4 + [8] * 31,
                 initial_inventory=[12, 12, 12, 12], inv_cost=1, backlog_cost=2,
                 exceeded_capacity_penalty=100, shipment_delays=2,
                 initial_shipment=4, initial_orders=4, seed=None,
                 device="cuda"):
        self.DEBUG = False
        self.levels = levels
        self.max_stock = max_stock
        self.action_space = OldGymMultiDiscrete(levels * [max_order])
        self.observation_space = OldGymMultiDiscrete(levels * [2 * max_stock])
        self.inv_cost = inv_cost
        self.backlog_cost = backlog_cost
        self.exceeded_capacity_penalty = exceeded_capacity_penalty
        self.max_weeks = weeks

        # stochastic ranges are 2-element tuples/lists (beergame2_env.py:41-58)
        if isinstance(customer_demand, tuple) or (
                isinstance(customer_demand, list) and len(customer_demand) == 2):
            self.stochastic_demand_range = customer_demand
            self.customer_demand = None
        else:
            self.stochastic_demand_range = None
            self.customer_demand = np.asarray(customer_demand, dtype=int)

        self.stochastic_shipdelays_range = None
        if isinstance(shipment_delays, int):
            self.shipment_delays = np.asarray(
                [2] + self.max_weeks * [shipment_delays], dtype=int)
            max_delay = max(2, shipment_delays)
        elif isinstance(shipment_delays, tuple) or (
                isinstance(shipment_delays, list) and len(shipment_delays) == 2):
            self.stochastic_shipdelays_range = shipment_delays
            self.shipment_delays = None
            max_delay = max(2, shipment_delays[1])   # randint high is exclusive
        else:
            self.shipment_delays = np.asarray([2] + shipment_delays, dtype=int)
            max_delay = int(self.shipment_delays.max())

        if self.stochastic_demand_range or self.stochastic_shipdelays_range:
            self.rand_generator = np.random.RandomState(seed)

        self.initial_inventory = np.asarray(initial_inventory, dtype=int)
        self.initial_shipment_value = initial_shipment
        self.initial_orders_value = initial_orders
        self.current_state = None
        self._build(max_delay, device,
                    exceeded_capacity_penalty=exceeded_capacity_penalty,
                    max_stock=max_stock, v2=True)

    def seed(self, seed=None):
        self.rand_generator = np.random.RandomState(seed)

    def _generate_stochastic_data(self, arange, asize):
        return self.rand_generator.randint(low=arange[0], high=arange[1],
                                           size=asize)

    def reset(self):
        if self.stochastic_demand_range:
            self.customer_demand = self._generate_stochastic_data(
                self.stochastic_demand_range, self.max_weeks)
        if self.stochastic_shipdelays_range:
            delays = self._generate_stochastic_data(
                self.stochastic_shipdelays_range, self.max_weeks)
            self.shipment_delays = np.insert(delays, 0, 2)
        return self._reset_state()

    def render(self, mode='human'):
        print('\n' + '=' * 20)
        print('Week:\t', self.week)
        inv, back = self.inventory, self.backlog
        print('Inventory/back:\t', inv, back, inv - back)
        if self.week < self.max_weeks:
            print('Next customer demand:\t', self.customer_demand[self.week])
        print('Penalty costs:\t', to_host(self.state.penalty_costs)[:, 0])
