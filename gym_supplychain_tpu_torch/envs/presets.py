"""Configurations of the ported slices, as compiled chains and env classes.

The topology builders of the JAX package's ``SupplyChainLinearEnv``,
``SupplyChainOneOneNEnv``, ``SupplyChainNtoMEnv``,
``SupplyChain2perStageEnv`` (and its seasonal variant),
``SupplyChainMultiProduct`` (and its ``_IncreasingCosts``,
``_DemConfigByProd`` and ``_DemConfigByProd_IncCosts`` variants) and
``SupplyChainNPerStage`` (``gym_supplychain_tpu/envs/presets.py``), and of
its generic ``SupplyChainEnv`` (``envs/single.py``), returning a
``CompiledChain`` instead of a single-env object, plus the classic beer
game's defaults.  Values are those of the JAX presets, which mirror the
reference's README topologies, its ``__main__`` demo, its
``SupplyChain2perStageEnv`` (and seasonal variant), its multi-product
environments and its N-per-stage environment.

The single-env classes of the JAX presets (same names, same keyword
arguments) are thin subclasses of ``envs/single.py``'s ``SupplyChainEnv``
that take their chain from these builders.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.compile import CompiledChain, compile_chain
from .single import SupplyChainEnv

__all__ = ["supplychain_chain", "linear_chain", "oneonen_chain",
           "ntom_chain", "twoperstage_chain", "twoperstage_seasonal_chain",
           "multiproduct_chain", "multiproduct_inccosts_chain",
           "multiproduct_v1_chain", "multiproduct_v1_inccosts_chain",
           "nperstage_chain", "BeerGameSpec", "beergame_v0", "beergame_v2",
           "SupplyChain2perStageEnv", "SupplyChain2perStageSeasonalEnv",
           "SupplyChainMultiProduct", "SupplyChainMultiProduct_IncreasingCosts",
           "SupplyChainMultiProduct_DemConfigByProd",
           "SupplyChainMultiProduct_DemConfigByProd_IncCosts",
           "SupplyChainNPerStage", "SupplyChainLinearEnv",
           "SupplyChainOneOneNEnv", "SupplyChainNtoMEnv"]


def supplychain_chain(nodes_info, **kw) -> CompiledChain:
    """``supplychain-v0``: the caller's ``nodes_info`` (the reference
    schema) with ``SupplyChainEnv``'s defaults, which are
    ``compile_chain``'s."""
    return compile_chain(nodes_info, **kw)


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


def oneonen_chain(num_retailers=2, num_products=1, demand_range=(10, 20),
                  initial_stock=10, stock_capacity=600, stock_cost=1,
                  dest_cost=2, supply_cost=5, supply_capacity=150,
                  processing_cost=10, processing_capacity=300,
                  ship_capacity=300, processing_ratio=3,
                  unmet_demand_cost=1000, exceeded_stock_capacity_cost=1000,
                  exceeded_process_capacity_cost=1000,
                  exceeded_ship_capacity_cost=1000,
                  stochastic_leadtimes=False, avg_leadtime=2, max_leadtime=2,
                  total_time_steps=360, **kw) -> CompiledChain:
    """``supplychain-oneonen-v0``: one supplier, one factory, one
    wholesaler fanning out to ``num_retailers`` retailers."""
    retailers = [f'Retailer{i + 1}' for i in range(num_retailers)]
    common = {'initial_stock': initial_stock,
              'stock_capacity': stock_capacity, 'stock_cost': stock_cost}
    nodes_info = {
        'Supplier': {**common, 'supply_capacity': supply_capacity,
                     'supply_cost': supply_cost, 'destinations': ['Factory'],
                     'dest_costs': [[dest_cost]] * num_products,
                     'ship_capacity': [ship_capacity]},
        'Factory': {**common, 'processing_capacity': processing_capacity,
                    'processing_cost': processing_cost,
                    'destinations': ['Wholesal'],
                    'dest_costs': [[dest_cost]] * num_products,
                    'ship_capacity': [ship_capacity]},
        'Wholesal': {**common, 'destinations': retailers,
                     'dest_costs': [[dest_cost] * num_retailers]
                     * num_products,
                     'ship_capacity': [ship_capacity] * num_retailers},
    }
    for r in retailers:
        nodes_info[r] = {**common, 'last_level': True}
    return compile_chain(
        nodes_info, num_products=num_products, demand_range=demand_range,
        unmet_demand_cost=unmet_demand_cost,
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


def twoperstage_chain(num_products=1, initial_stocks=(0,) * 8,
                      initial_supply=([[60, 60]],) * 2,
                      initial_shipments=([[60, 60]],) * 2 + ([[20, 20]],) * 4,
                      supply_capacities=(120, 150),
                      processing_capacities=(300, 300),
                      stock_capacities=(200, 300) * 4, ship_capacity=300,
                      processing_ratio=3, processing_costs=(12, 10),
                      stock_costs=(1,) * 8, supply_costs=(6, 4), dest_cost=2,
                      unmet_demand_cost=216, exceeded_stock_capacity_cost=10,
                      exceeded_process_capacity_cost=10,
                      exceeded_ship_capacity_cost=10, demand_range=(10, 20),
                      stochastic_leadtimes=False, avg_leadtime=2,
                      max_leadtime=2, total_time_steps=360,
                      **kw) -> CompiledChain:
    """``supplychain-2perstage-v0`` (``sc-2perstage-v0``): 2 suppliers ->
    2 factories -> 2 wholesalers -> 2 retailers, full bipartite between
    stages, with seeded initial supplies and shipments."""
    nodes_info = {}
    stages = (("Supplier", ["Factory1", "Factory2"]),
              ("Factory", ["WholeSaler1", "WholeSaler2"]),
              ("WholeSaler", ["Retailer1", "Retailer2"]),
              ("Retailer", None))
    for s, (stage, dests) in enumerate(stages):
        for i in range(2):
            n = 2 * s + i
            node = {'initial_stock': initial_stocks[n],
                    'stock_capacity': stock_capacities[n],
                    'stock_cost': stock_costs[n]}
            if s == 0:
                node.update({'initial_supply': initial_supply[i],
                             'supply_capacity': supply_capacities[i],
                             'supply_cost': supply_costs[i]})
            else:
                node['initial_shipments'] = initial_shipments[n - 2]
            if s == 1:
                node.update({'processing_capacity': processing_capacities[i],
                             'processing_cost': processing_costs[i]})
            if dests is None:
                node['last_level'] = True
            else:
                node.update({'destinations': dests,
                             'dest_costs': [[dest_cost] * 2] * num_products,
                             'ship_capacity': [ship_capacity] * 2})
            nodes_info[f"{stage}{i + 1}"] = node
    return compile_chain(
        nodes_info, num_products=num_products,
        unmet_demand_cost=unmet_demand_cost,
        exceeded_stock_capacity_cost=exceeded_stock_capacity_cost,
        exceeded_process_capacity_cost=exceeded_process_capacity_cost,
        exceeded_ship_capacity_cost=exceeded_ship_capacity_cost,
        processing_ratio=processing_ratio, demand_range=demand_range,
        stochastic_leadtimes=stochastic_leadtimes, avg_leadtime=avg_leadtime,
        max_leadtime=max_leadtime, total_time_steps=total_time_steps, **kw)


def twoperstage_seasonal_chain(
        num_products=1, initial_stocks=(800,) * 8,
        initial_supply=([[600, 600]], [[840, 840]]),
        initial_shipments=([[600, 600]], [[840, 840]]) + ([[240, 240]],) * 4,
        supply_capacities=(600, 840), processing_capacities=(840, 960),
        stock_capacities=(1600, 1800) * 4, ship_capacity=1800,
        demand_range=(0, 400), demand_std=10, demand_sen_peaks=4,
        avg_demand_range=(150, 250), demand_perturb_norm=True,
        **kw) -> CompiledChain:
    """``sc-2perstage-seasonal-v0``: the 2-per-stage chain with 10x larger
    stocks and capacities and seasonal demand (4 peaks a horizon between
    150 and 250, a normal perturbation of std 10, clipped to [0, 400])."""
    return twoperstage_chain(
        num_products=num_products, initial_stocks=initial_stocks,
        initial_supply=initial_supply, initial_shipments=initial_shipments,
        supply_capacities=supply_capacities,
        processing_capacities=processing_capacities,
        stock_capacities=stock_capacities, ship_capacity=ship_capacity,
        demand_range=demand_range, demand_std=demand_std,
        demand_sen_peaks=demand_sen_peaks, avg_demand_range=avg_demand_range,
        demand_perturb_norm=demand_perturb_norm, **kw)


def _multiproduct_nodes(initial_stocks, stock_capacities, stock_costs,
                        initial_supply, supply_capacities, supply_costs,
                        dest_cost, ship_capacity, initial_shipments,
                        processing_capacities, processing_costs):
    """8-node multi-product chain: 2 suppliers -> 2 factories -> 2
    wholesalers -> 2 retailers, full bipartite between stages."""
    nodes_info = {}
    stages = (("Supplier", ["Factory1", "Factory2"]),
              ("Factory", ["Wholesal1", "Wholesal2"]),
              ("Wholesal", ["Retailer1", "Retailer2"]),
              ("Retailer", None))
    for s, (stage, dests) in enumerate(stages):
        for i in range(2):
            n = 2 * s + i
            node = {'initial_stock': initial_stocks[n],
                    'stock_capacity': stock_capacities[n],
                    'stock_cost': stock_costs}
            if s == 0:
                node.update({'initial_supply': initial_supply[i],
                             'supply_capacity': supply_capacities[i],
                             'supply_cost': supply_costs[i]})
            else:
                node['initial_shipments'] = initial_shipments[n - 2]
            if s == 1:
                node.update({'processing_capacity': processing_capacities[i],
                             'processing_cost': processing_costs[i]})
            if dests is None:
                node['last_level'] = True
            else:
                node.update({'destinations': dests, 'dest_costs': dest_cost,
                             'ship_capacity': ship_capacity})
            nodes_info[f"{stage}{i + 1}"] = node
    return nodes_info


def multiproduct_chain(num_products=2, initial_stocks=None,
                       stock_capacities=None, stock_costs=1,
                       initial_supply=None, supply_capacities=None,
                       supply_costs=None, dest_cost=None, ship_capacity=None,
                       initial_shipments=None, processing_capacities=None,
                       processing_costs=None, processing_ratio=3,
                       unmet_demand_cost=216, exceeded_stock_capacity_cost=10,
                       exceeded_process_capacity_cost=10,
                       exceeded_ship_capacity_cost=10, demand_range=(0, 400),
                       stochastic_leadtimes=False, avg_leadtime=2,
                       max_leadtime=2, total_time_steps=360,
                       **kw) -> CompiledChain:
    """``sc-2perstage-multiproduct-v0``: the 8-node chain with
    ``num_products`` products and capacities scaled by it."""
    P, L = num_products, avg_leadtime
    if not stock_capacities:
        stock_capacities = [[c] * P for c in (1600, 1800, 6400, 7200,
                                              1600, 1800, 1600, 1800)]
    if not initial_stocks:
        initial_stocks = [[800] * P] * 8
    if not initial_supply:
        initial_supply = [[[600] * L] * P, [[840] * L] * P]
    if not supply_capacities:
        supply_capacities = [[600] * P, [840] * P]
    if not supply_costs:
        supply_costs = [[6] * P, [4] * P]
    if not dest_cost:
        dest_cost = [[2] * 2] * P
    if not ship_capacity:
        ship_capacity = [500 * P, 500 * P]
    if not initial_shipments:
        initial_shipments = ([[[600] * L] * P, [[840] * L] * P]
                             + [[[240] * L] * P] * 4)
    if not processing_capacities:
        processing_capacities = [840 * P, 960 * P]
    if not processing_costs:
        processing_costs = [[12] * P, [10] * P]
    nodes_info = _multiproduct_nodes(
        initial_stocks, stock_capacities, stock_costs, initial_supply,
        supply_capacities, supply_costs, dest_cost, ship_capacity,
        initial_shipments, processing_capacities, processing_costs)
    return compile_chain(
        nodes_info, num_products=P, unmet_demand_cost=unmet_demand_cost,
        exceeded_stock_capacity_cost=exceeded_stock_capacity_cost,
        exceeded_process_capacity_cost=exceeded_process_capacity_cost,
        exceeded_ship_capacity_cost=exceeded_ship_capacity_cost,
        processing_ratio=processing_ratio, demand_range=demand_range,
        stochastic_leadtimes=stochastic_leadtimes, avg_leadtime=avg_leadtime,
        max_leadtime=max_leadtime, total_time_steps=total_time_steps, **kw)


def multiproduct_inccosts_chain(num_products=2, **kw) -> CompiledChain:
    """``sc-2perstage-multiproduct-inccosts-v0``: the multi-product chain
    with every cost scaled by (product index + 1)."""
    P = num_products
    return multiproduct_chain(
        num_products=P,
        supply_costs=[[6 * (i + 1) for i in range(P)],
                      [4 * (i + 1) for i in range(P)]],
        dest_cost=[[2 * (i + 1)] * 2 for i in range(P)],
        processing_costs=[[12 * (i + 1) for i in range(P)],
                          [10 * (i + 1) for i in range(P)]],
        stock_costs=[i + 1 for i in range(P)], **kw)


def _dem_by_prod_cfg(num_products, demand_std):
    """Per-product demand ranges, stds, peaks and average ranges of the
    ``DemConfigByProd`` variants: seasonal (4 peaks), uniform or normal,
    seasonal (2 peaks) for products 1-3."""
    assert 1 <= num_products <= 3
    demand_range = [(0, 400)]
    demand_stds = [demand_std]
    demand_sen_peaks = [4]
    avg_demand_range = [(100, 300)]
    if num_products > 1:
        demand_range.append((0, 300))
        demand_stds.append(demand_std)
        demand_sen_peaks.append(None)
        avg_demand_range.append(None)
    if num_products > 2:
        demand_range.append((0, 400))
        demand_stds.append(demand_std)
        demand_sen_peaks.append(2)
        avg_demand_range.append((100, 300))
    return demand_range, demand_stds, demand_sen_peaks, avg_demand_range


def _by_prod_kw(num_products, demand_std, demand_perturb_norm):
    rng, stds, peaks, avg = _dem_by_prod_cfg(num_products, demand_std)
    return dict(demand_config_by_product=True, num_products=num_products,
                demand_range=rng, demand_std=stds, demand_sen_peaks=peaks,
                avg_demand_range=avg,
                demand_perturb_norm=[demand_perturb_norm] * num_products)


def multiproduct_v1_chain(num_products=2, demand_std=None,
                          demand_perturb_norm=False, **kw) -> CompiledChain:
    """``sc-2perstage-multiproduct-v1``: the multi-product chain with a
    demand process per product (``_dem_by_prod_cfg``)."""
    return multiproduct_chain(**_by_prod_kw(num_products, demand_std,
                                            demand_perturb_norm), **kw)


def multiproduct_v1_inccosts_chain(num_products=2, demand_std=None,
                                   demand_perturb_norm=False,
                                   **kw) -> CompiledChain:
    """``sc-2perstage-multiproduct-inccosts-v1``: the increasing-cost
    multi-product chain with a demand process per product."""
    return multiproduct_inccosts_chain(**_by_prod_kw(
        num_products, demand_std, demand_perturb_norm), **kw)


def nperstage_chain(nodes_per_echelon=3, num_products=2, initial_stocks=None,
                    stock_capacities=None, stock_costs=1, initial_supply=None,
                    supply_capacities=None, supply_costs=None, dest_cost=None,
                    ship_capacity=None, initial_shipments=None,
                    processing_capacities=None, processing_costs=None,
                    processing_ratio=3, unmet_demand_cost=216,
                    exceeded_stock_capacity_cost=10,
                    exceeded_process_capacity_cost=10,
                    exceeded_ship_capacity_cost=10, demand_range=(0, 400),
                    stochastic_leadtimes=False, avg_leadtime=2,
                    max_leadtime=2, total_time_steps=360,
                    **kw) -> CompiledChain:
    """``sc-Nperstage-multiproduct-v0``: 4 echelons (suppliers, factories,
    wholesalers, retailers) of ``nodes_per_echelon`` nodes (an int, or one
    count per echelon), full bipartite between echelons."""
    P, L = num_products, avg_leadtime
    if isinstance(nodes_per_echelon, int):
        nodes_per_echelon = [nodes_per_echelon] * 4
    ns, nf, nw, nr = nodes_per_echelon
    ne = {'suppliers': ns, 'factories': nf, 'wholesalers': nw,
          'retailers': nr}
    if not stock_capacities:
        stock_capacities = {k: [[6400 if k == 'factories' else 1600] * P]
                            * ne[k] for k in ne}
    if not initial_stocks:
        initial_stocks = {k: [[800] * P] * ne[k] for k in ne}
    if not initial_supply:
        initial_supply = [[[600] * L] * P] * ns
    if not supply_capacities:
        supply_capacities = [[600] * P] * ns
    if not supply_costs:
        supply_costs = [[6] * P] * ns
    if not dest_cost:
        dest_cost = {'suppliers': [[2] * nf] * P,
                     'factories': [[2] * nw] * P,
                     'wholesalers': [[2] * nr] * P}
    if not ship_capacity:
        ship_capacity = {'suppliers': [500 * P] * nf,
                         'factories': [500 * P] * nw,
                         'wholesalers': [500 * P] * nr}
    if not initial_shipments:
        initial_shipments = {'factories': [[[600] * L] * P] * nf,
                             'wholesalers': [[[240] * L] * P] * nw,
                             'retailers': [[[240] * L] * P] * nr}
    if not processing_capacities:
        processing_capacities = [840 * P] * nf
    if not processing_costs:
        processing_costs = [[12] * P] * nf

    nodes_info = {}
    for i in range(ns):
        nodes_info[f'Supplier{i}'] = {
            'initial_stock': initial_stocks['suppliers'][i],
            'stock_capacity': stock_capacities['suppliers'][i],
            'stock_cost': stock_costs, 'initial_supply': initial_supply[i],
            'supply_capacity': supply_capacities[i],
            'supply_cost': supply_costs[i],
            'destinations': [f'Factory{j}' for j in range(nf)],
            'dest_costs': dest_cost['suppliers'],
            'ship_capacity': ship_capacity['suppliers']}
    for i in range(nf):
        nodes_info[f'Factory{i}'] = {
            'initial_stock': initial_stocks['factories'][i],
            'stock_capacity': stock_capacities['factories'][i],
            'stock_cost': stock_costs,
            'initial_shipments': initial_shipments['factories'][i],
            'processing_capacity': processing_capacities[i],
            'processing_cost': processing_costs[i],
            'destinations': [f'Wholesal{j}' for j in range(nw)],
            'dest_costs': dest_cost['factories'],
            'ship_capacity': ship_capacity['factories']}
    for i in range(nw):
        nodes_info[f'Wholesal{i}'] = {
            'initial_stock': initial_stocks['wholesalers'][i],
            'stock_capacity': stock_capacities['wholesalers'][i],
            'stock_cost': stock_costs,
            'initial_shipments': initial_shipments['wholesalers'][i],
            'destinations': [f'Retailer{j}' for j in range(nr)],
            'dest_costs': dest_cost['wholesalers'],
            'ship_capacity': ship_capacity['wholesalers']}
    for i in range(nr):
        nodes_info[f'Retailer{i}'] = {
            'initial_stock': initial_stocks['retailers'][i],
            'stock_capacity': stock_capacities['retailers'][i],
            'stock_cost': stock_costs,
            'initial_shipments': initial_shipments['retailers'][i],
            'last_level': True}
    return compile_chain(
        nodes_info, num_products=P, unmet_demand_cost=unmet_demand_cost,
        exceeded_stock_capacity_cost=exceeded_stock_capacity_cost,
        exceeded_process_capacity_cost=exceeded_process_capacity_cost,
        exceeded_ship_capacity_cost=exceeded_ship_capacity_cost,
        processing_ratio=processing_ratio, demand_range=demand_range,
        stochastic_leadtimes=stochastic_leadtimes, avg_leadtime=avg_leadtime,
        max_leadtime=max_leadtime, total_time_steps=total_time_steps, **kw)


@dataclasses.dataclass(frozen=True)
class BeerGameSpec:
    """A beer game configuration: the arguments its collectors take (the
    last four are the revised game's, ``v2``)."""
    levels: int
    weeks: int
    demand: Tuple[int, ...]
    delay: int
    init_inv: int
    init_ship: int
    init_orders: int
    inv_cost: int
    backlog_cost: int
    v2: bool = False
    max_stock: int = 0
    max_order: int = 0
    exceeded_capacity_penalty: int = 0


def beergame_v0(weeks: int = 35, **kw) -> BeerGameSpec:
    """``beergame-v0``: the classic 4-level game, 35 weeks, demand 4 for
    four weeks then 8, constant delay 2 (reference beergame_env.py)."""
    spec = dict(levels=4, weeks=weeks,
                demand=tuple([4] * 4 + [8] * (weeks - 4)),
                delay=2, init_inv=12, init_ship=4, init_orders=4, inv_cost=1,
                backlog_cost=2)
    spec.update(kw)
    return BeerGameSpec(**spec)


def beergame_v2(weeks: int = 35, **kw) -> BeerGameSpec:
    """``beergame-v2``: the revised game's defaults (reference
    beergame2_env.py): ``beergame-v0``'s, with orders in [0, 30), stock
    observed against 100 and a penalty of 100 a unit of inventory or
    backlog past it."""
    spec = dict(v2=True, max_stock=100, max_order=30,
                exceeded_capacity_penalty=100)
    spec.update(kw)
    return beergame_v0(weeks, **spec)


class _PresetEnv(SupplyChainEnv):
    """A single env whose chain comes from a builder of this module: the
    builder's keyword arguments, then the single env's own."""

    _chain = None

    def __init__(self, seed=None, build_info=False, dtype=None,
                 strict_obs=False, device="cuda", **kw):
        super().__init__(cc=type(self)._chain(**kw), seed=seed,
                         build_info=build_info, dtype=dtype,
                         strict_obs=strict_obs, device=device)


class SupplyChain2perStageEnv(_PresetEnv):
    """``sc-2perstage-v0``: ``twoperstage_chain``."""
    _chain = staticmethod(twoperstage_chain)


class SupplyChain2perStageSeasonalEnv(_PresetEnv):
    """``sc-2perstage-seasonal-v0``: ``twoperstage_seasonal_chain``."""
    _chain = staticmethod(twoperstage_seasonal_chain)


class SupplyChainMultiProduct(_PresetEnv):
    """``sc-2perstage-multiproduct-v0``: ``multiproduct_chain``."""
    _chain = staticmethod(multiproduct_chain)


class SupplyChainMultiProduct_IncreasingCosts(_PresetEnv):
    """``sc-2perstage-multiproduct-inccosts-v0``:
    ``multiproduct_inccosts_chain``."""
    _chain = staticmethod(multiproduct_inccosts_chain)


class SupplyChainMultiProduct_DemConfigByProd(_PresetEnv):
    """``sc-2perstage-multiproduct-v1``: ``multiproduct_v1_chain``."""
    _chain = staticmethod(multiproduct_v1_chain)


class SupplyChainMultiProduct_DemConfigByProd_IncCosts(_PresetEnv):
    """``sc-2perstage-multiproduct-inccosts-v1``:
    ``multiproduct_v1_inccosts_chain``."""
    _chain = staticmethod(multiproduct_v1_inccosts_chain)


class SupplyChainNPerStage(_PresetEnv):
    """``sc-Nperstage-multiproduct-v0``: ``nperstage_chain``."""
    _chain = staticmethod(nperstage_chain)


class SupplyChainLinearEnv(_PresetEnv):
    """``supplychain-linear-v0``: ``linear_chain``."""
    _chain = staticmethod(linear_chain)


class SupplyChainOneOneNEnv(_PresetEnv):
    """``supplychain-oneonen-v0``: ``oneonen_chain``."""
    _chain = staticmethod(oneonen_chain)


class SupplyChainNtoMEnv(_PresetEnv):
    """``supplychain-ntom-v0``: ``ntom_chain``."""
    _chain = staticmethod(ntom_chain)
