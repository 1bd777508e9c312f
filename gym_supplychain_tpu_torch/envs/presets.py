"""Configurations of the rollout slice, as compiled chains.

The topology builders of the JAX package's ``SupplyChainLinearEnv`` and
``SupplyChainNtoMEnv`` (``gym_supplychain_tpu/envs/presets.py``), returning
a ``CompiledChain`` instead of a single-env object, plus the classic beer
game's defaults.  Values are those of the JAX presets, which mirror the
reference's README topologies and its ``__main__`` demo.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.compile import CompiledChain, compile_chain

__all__ = ["linear_chain", "ntom_chain", "BeerGameSpec", "beergame_v0"]


def _linear_nodes(num_products=1, initial_stock=10, stock_capacity=100,
                  stock_cost=1, dest_cost=2, supply_cost=5, supply_capacity=50,
                  processing_cost=10, processing_capacity=100,
                  ship_capacity=100):
    """4-node linear chain Supplier -> Factory -> Wholesal -> Retailer."""
    nodes_info = {}
    nodes_info['Supplier'] = {'initial_stock': initial_stock, 'stock_capacity': stock_capacity,
                              'stock_cost': stock_cost, 'supply_capacity': supply_capacity,
                              'supply_cost': supply_cost, 'destinations': ['Factory'],
                              'dest_costs': [[dest_cost]] * num_products,
                              'ship_capacity': [ship_capacity]}
    nodes_info['Factory'] = {'initial_stock': initial_stock, 'stock_capacity': stock_capacity,
                             'stock_cost': stock_cost, 'processing_capacity': processing_capacity,
                             'processing_cost': processing_cost, 'destinations': ['Wholesal'],
                             'dest_costs': [[dest_cost]] * num_products,
                             'ship_capacity': [ship_capacity]}
    nodes_info['Wholesal'] = {'initial_stock': initial_stock, 'stock_capacity': stock_capacity,
                              'stock_cost': stock_cost, 'destinations': ['Retailer'],
                              'dest_costs': [[dest_cost]] * num_products,
                              'ship_capacity': [ship_capacity]}
    nodes_info['Retailer'] = {'initial_stock': initial_stock, 'stock_capacity': stock_capacity,
                              'stock_cost': stock_cost, 'last_level': True}
    return nodes_info


def linear_chain(num_products=1, demand_range=(0, 5), unmet_demand_cost=1000,
                 exceeded_stock_capacity_cost=1000,
                 exceeded_process_capacity_cost=1000,
                 exceeded_ship_capacity_cost=1000, processing_ratio=2,
                 stochastic_leadtimes=False, avg_leadtime=2, max_leadtime=2,
                 total_time_steps=360, **kw) -> CompiledChain:
    """``supplychain-linear-v0``: the 4-node linear chain."""
    return compile_chain(
        _linear_nodes(num_products=num_products), num_products=num_products,
        demand_range=demand_range, unmet_demand_cost=unmet_demand_cost,
        exceeded_stock_capacity_cost=exceeded_stock_capacity_cost,
        exceeded_process_capacity_cost=exceeded_process_capacity_cost,
        exceeded_ship_capacity_cost=exceeded_ship_capacity_cost,
        processing_ratio=processing_ratio,
        stochastic_leadtimes=stochastic_leadtimes, avg_leadtime=avg_leadtime,
        max_leadtime=max_leadtime, total_time_steps=total_time_steps, **kw)


def ntom_chain(num_products=1, demand_range=(10, 20), stock_capacity=300,
               ship_capacity=300, supply_capacity=50, processing_capacity=50,
               processing_ratio=3, stochastic_leadtimes=True, avg_leadtime=2,
               max_leadtime=4, stock_cost=1, total_time_steps=360,
               **kw) -> CompiledChain:
    """``supplychain-ntom-v0``: the 2-2-2-2 full-bipartite graph with its
    derived cost structure."""
    dest_cost = 2 * stock_cost
    supply_cost = 5 * stock_cost
    processing_cost = 2 * supply_cost
    product_cost = supply_cost + 3 * avg_leadtime * dest_cost + processing_cost
    unmet_demand_cost = 2 * product_cost
    exceeded_capacity_cost = 10 * stock_cost
    nodes_info = {}
    for i, stock0 in (('1', 10), ('2', 0)):
        nodes_info[f'Supplier {i}'] = {
            'initial_stock': stock0, 'stock_capacity': stock_capacity,
            'stock_cost': stock_cost, 'supply_capacity': supply_capacity,
            'supply_cost': supply_cost,
            'destinations': ['Factory  1', 'Factory  2'],
            'dest_costs': [[dest_cost] * 2] * num_products,
            'ship_capacity': [ship_capacity] * 2}
    for i in ('1', '2'):
        nodes_info[f'Factory  {i}'] = {
            'initial_stock': 0, 'stock_capacity': stock_capacity,
            'stock_cost': stock_cost, 'processing_capacity': processing_capacity,
            'processing_cost': processing_cost,
            'destinations': ['Wholesal 1', 'Wholesal 2'],
            'dest_costs': [[dest_cost] * 2] * num_products,
            'ship_capacity': [ship_capacity] * 2}
    for i, stock0 in (('1', 10), ('2', 15)):
        nodes_info[f'Wholesal {i}'] = {
            'initial_stock': stock0, 'stock_capacity': stock_capacity,
            'stock_cost': stock_cost,
            'destinations': ['Retailer 1', 'Retailer 2'],
            'dest_costs': [[dest_cost] * 2] * num_products,
            'ship_capacity': [ship_capacity] * 2}
    for i, stock0 in (('1', 10), ('2', 20)):
        nodes_info[f'Retailer {i}'] = {
            'initial_stock': stock0, 'stock_capacity': stock_capacity,
            'stock_cost': stock_cost, 'last_level': True}
    return compile_chain(
        nodes_info, num_products=num_products, demand_range=demand_range,
        unmet_demand_cost=unmet_demand_cost,
        exceeded_stock_capacity_cost=exceeded_capacity_cost,
        exceeded_process_capacity_cost=exceeded_capacity_cost,
        exceeded_ship_capacity_cost=exceeded_capacity_cost,
        processing_ratio=processing_ratio,
        stochastic_leadtimes=stochastic_leadtimes, avg_leadtime=avg_leadtime,
        max_leadtime=max_leadtime, total_time_steps=total_time_steps, **kw)


@dataclasses.dataclass(frozen=True)
class BeerGameSpec:
    """A beer game configuration: the arguments its collectors take."""
    levels: int
    weeks: int
    demand: Tuple[int, ...]
    delay: int
    init_inv: int
    init_ship: int
    init_orders: int
    inv_cost: int
    backlog_cost: int


def beergame_v0(weeks: int = 35, **kw) -> BeerGameSpec:
    """``beergame-v0``: the classic 4-level game, 35 weeks, demand 4 for
    four weeks then 8, constant delay 2 (reference beergame_env.py)."""
    spec = dict(levels=4, weeks=weeks,
                demand=tuple([4] * 4 + [8] * (weeks - 4)),
                delay=2, init_inv=12, init_ship=4, init_orders=4, inv_cost=1,
                backlog_cost=2)
    spec.update(kw)
    return BeerGameSpec(**spec)
