"""Batched MIT Beer Game step engine (v0 and v2) in eager PyTorch.

The counterpart of ``gym_supplychain_tpu/core/beergame.py``: per-week state
``[levels, B]`` with the batch as the trailing axis, and the shipment
pipeline as a ring ``[max_delay + 1, levels, B]`` indexed by ``week % R``.
All arithmetic is integer, so the engine is bit-exact against the JAX one
and against the CUDA collect kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BeerGameState", "make_beergame_kernels"]


class BeerGameState(NamedTuple):
    week: int                           # shared clock (Python int)
    inventory: torch.Tensor             # [L, B]
    backlog: torch.Tensor               # [L, B]
    orders_placed: torch.Tensor         # [L, B]
    incoming_orders: torch.Tensor       # [L, B]
    shipments: torch.Tensor             # [R, L, B] ring, slot = week % R
    customer_demand: torch.Tensor       # [max_weeks, B]
    shipment_delays: torch.Tensor       # [max_weeks + 1, B]
    inventory_costs: torch.Tensor       # [L, B]
    backlog_costs: torch.Tensor         # [L, B]
    penalty_costs: torch.Tensor         # [L, B]


def make_beergame_kernels(levels: int, max_weeks: int, max_delay: int,
                          inv_cost=1, backlog_cost=2,
                          exceeded_capacity_penalty=0, max_stock: int = 0,
                          v2: bool = False, itype=torch.int32, device="cuda"):
    """Build ``(reset_fn, step_fn, obs_fn)`` for a beer game family.

    ``max_delay`` bounds every shipment delay (including the prepended
    initial delay in slot 0 of the delays table) and sizes the ring:
    R = max_delay + 1.
    """
    device = torch.device(device)
    L = levels
    R = max_delay + 1
    ridx = torch.arange(R, dtype=itype, device=device)[:, None]     # [R,1]

    def _table(x, B):
        x = torch.as_tensor(x, dtype=itype, device=device)
        return x[:, None].expand(x.shape[0], B) if x.ndim == 1 else x

    def reset_fn(customer_demand, shipment_delays, initial_inventory,
                 initial_shipment_value, initial_orders_value, B: int):
        """State from episode tables: ``customer_demand`` [weeks(, B)],
        ``shipment_delays`` [weeks + 1(, B)] with the prepended initial
        delay in slot 0, ``initial_inventory`` [L(, B)]."""
        demand = _table(customer_demand, B)
        delays = _table(shipment_delays, B)
        inv0 = torch.as_tensor(initial_inventory, dtype=itype, device=device)
        if inv0.ndim == 1:
            inv0 = inv0[:, None].expand(L, B)
        inv0 = inv0.clone()
        # shipments[1 : 1 + delays[0]] = initial_shipment_value
        seeded = (ridx >= 1) & (ridx <= delays[0][None, :])          # [R,B]
        ship0 = torch.where(seeded[:, None, :],
                            torch.tensor(initial_shipment_value, dtype=itype,
                                         device=device),
                            torch.tensor(0, dtype=itype, device=device))
        ship0 = ship0.expand(R, L, B).clone()
        orders0 = torch.full((L, B), initial_orders_value, dtype=itype,
                             device=device)
        zeros = torch.zeros((L, B), dtype=itype, device=device)
        return BeerGameState(
            week=0, inventory=inv0, backlog=zeros, orders_placed=orders0,
            incoming_orders=orders0, shipments=ship0, customer_demand=demand,
            shipment_delays=delays, inventory_costs=zeros,
            backlog_costs=zeros, penalty_costs=zeros)

    def obs_fn(state: BeerGameState):
        if v2:
            return max_stock + state.inventory - state.backlog
        return state.inventory - state.backlog

    def step_fn(state: BeerGameState, action):
        """One week for the whole batch; ``action`` [L, B] int."""
        action = torch.as_tensor(action, dtype=itype, device=device)
        week = state.week + 1
        B = action.shape[-1]

        # 1. receive scheduled shipments
        slot = week % R
        inventory = state.inventory + state.shipments[slot]

        # 2. fill orders (incoming = customer demand, then upstream orders)
        incoming = torch.cat([state.customer_demand[week - 1][None],
                              state.orders_placed[:-1]], dim=0)
        orders_to_fill = incoming + state.backlog
        to_deliver = torch.minimum(inventory, orders_to_fill)

        # deliveries downstream and the factory's self-supply: immediate
        # into inventory when the delay is 0, scheduled otherwise
        delay = state.shipment_delays[week]                          # [B]
        zero_delay = delay == 0
        downstream = torch.cat([to_deliver[1:], state.orders_placed[-1:]], 0)
        sched = (ridx == ((week + delay) % R)[None, :]) & ~zero_delay  # [R,B]
        shipments = (torch.where(ridx[:, :, None] == slot, 0, state.shipments)
                     + torch.where(sched[:, None, :], downstream[None], 0))
        immediate = torch.where(zero_delay[None, :], downstream, 0)

        # 3. record inventory / backlog
        inventory = inventory - to_deliver + immediate
        backlog = orders_to_fill - to_deliver

        # 5. place orders
        orders_placed = action if v2 else incoming + action

        # 6. reward
        reward = -(inv_cost * inventory + backlog_cost * backlog).sum(0,
                                                                      dtype=itype)
        pen = torch.zeros((L, B), dtype=itype, device=device)
        if v2:
            pen = (torch.clamp_min(inventory - max_stock, 0)
                   + torch.clamp_min(backlog - max_stock, 0))
            reward = reward - (exceeded_capacity_penalty * pen).sum(0,
                                                                    dtype=itype)
        new_state = BeerGameState(
            week=week, inventory=inventory, backlog=backlog,
            orders_placed=orders_placed, incoming_orders=incoming,
            shipments=shipments, customer_demand=state.customer_demand,
            shipment_delays=state.shipment_delays,
            inventory_costs=state.inventory_costs + inv_cost * inventory,
            backlog_costs=state.backlog_costs + backlog_cost * backlog,
            penalty_costs=state.penalty_costs
            + exceeded_capacity_penalty * pen)
        return new_state, (obs_fn(new_state), reward, week == max_weeks)

    return reset_fn, step_fn, obs_fn
