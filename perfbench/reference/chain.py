"""The compiled chain, worked out from a configuration's ``chain`` block.

A frozen copy of the compiler the program uses (the reference schema's
``nodes_info`` dict to dense arrays), cut to what the benchmark's
configurations use: uniform integer demand shared by the products.  It
imports nothing of the program, so a change to the program's compiler
shows as a disagreement instead of moving both sides.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Chain", "compile_chain"]


class Chain(NamedTuple):
    N: int
    P: int
    R: int
    A: int
    K: int
    T: int
    Lavg: int
    Lmax: int
    H: int
    Dmax: int
    obs_dim: int
    stochastic: bool
    dem_min: float
    dem_max: float
    retailer_idx: np.ndarray
    initial_stock: np.ndarray     # [N, P]
    init_pipe: np.ndarray         # [H, N, P]
    stock_cap: np.ndarray
    stock_cost: np.ndarray
    has_supply: np.ndarray
    supply_cap: np.ndarray
    supply_cost: np.ndarray
    proc_cap: np.ndarray          # [N]
    proc_cost: np.ndarray
    proc_ratio: np.ndarray        # 1 where the node does not process
    is_factory: np.ndarray        # [N]
    is_retailer: np.ndarray
    edge_dst: np.ndarray          # [N, Dmax]
    edge_mask: np.ndarray
    ship_cap_edge: np.ndarray
    ship_cost: np.ndarray         # [N, P, Dmax]
    has_ship: np.ndarray          # [N, P]
    sup_act_idx: np.ndarray       # [N, P], -1 without a supply action
    ship_act_idx: np.ndarray      # [N, P, Dmax], -1 pad
    lt_base: np.ndarray           # [N]
    max_ship: np.ndarray          # [N, P]
    c_unmet: float
    c_stock_pen: float
    c_proc_pen: float
    c_ship_pen: float


def _per_product(v, P):
    if isinstance(v, list):
        if len(v) != P:
            raise ValueError(f"{v!r}: one value per product ({P})")
        return list(v)
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(f"{v!r}: an int or a list per product")
    return [v] * P


def compile_chain(chain: dict, T: int) -> Chain:
    """A configuration's ``chain`` block at horizon ``T`` -> ``Chain``.

    Node order is the dict's order, which fixes the action, observation and
    lead-time layouts.  Processing ratios are zeroed for nodes without a
    processing cost; the action vector holds each node's supply actions,
    then its ship actions product by product; ``K`` lead-time columns are
    drawn a step (P per supplying node and one per destination), consumed
    from ``lt_base[n]`` on."""
    nodes = chain["nodes_info"]
    P = int(chain.get("num_products", 1))
    lo, hi = chain["demand_range"]
    for key in ("demand_std", "demand_sen_peaks", "avg_demand_range",
                "demand_config_by_product"):
        if chain.get(key):
            raise NotImplementedError(f"{key}: the reference draws uniform "
                                      "integer demand only")
    names = list(nodes)
    N = len(names)
    at = {n: i for i, n in enumerate(names)}
    ratio_cfg = chain.get("processing_ratio", 3)
    z = lambda *s: np.zeros(s)  # noqa: E731
    initial_stock, stock_cap, stock_cost = z(N, P), z(N, P), z(N, P)
    supply_cap, supply_cost, proc_cost = z(N, P), z(N, P), z(N, P)
    has_supply = np.zeros((N, P), bool)
    proc_cap, proc_ratio = z(N), np.ones((N, P))
    is_retailer = np.zeros(N, bool)
    dests, inits = [None] * N, [[] for _ in range(N)]
    for i, name in enumerate(names):
        info = nodes[name]
        pc = info.get("processing_cost", 0)
        ratio = 0 if sum(_per_product(pc, P)) == 0 else ratio_cfg
        initial_stock[i] = _per_product(info.get("initial_stock", 0), P)
        stock_cap[i] = _per_product(info["stock_capacity"], P)
        stock_cost[i] = _per_product(info.get("stock_cost", 0), P)
        supply_cap[i] = _per_product(info.get("supply_capacity", 0), P)
        supply_cost[i] = _per_product(info.get("supply_cost", 0), P)
        if supply_cap[i].max() > 0:
            has_supply[i] = supply_cap[i] > 0
        proc_cap[i] = info.get("processing_capacity", 0)
        proc_cost[i] = _per_product(pc, P)
        proc_ratio[i] = _per_product(ratio, P)
        is_retailer[i] = bool(info.get("last_level", False))
        for key in ("initial_supply", "initial_shipments"):
            if info.get(key):
                inits[i].append(info[key])
        if "destinations" in info:
            dests[i] = ([at[d] for d in info["destinations"]],
                        list(info["ship_capacity"]), info["dest_costs"])
    is_factory = proc_cap > 0
    if (is_factory[:, None] & (proc_ratio == 0)).any():
        raise ValueError("a processing node with a zero processing ratio")
    proc_ratio = np.where(proc_ratio == 0, 1.0, proc_ratio)

    n_dests = np.array([len(d[0]) if d else 0 for d in dests])
    Dmax = max(1, int(n_dests.max()))
    edge_dst = np.zeros((N, Dmax), np.int64)
    edge_mask = np.zeros((N, Dmax), bool)
    ship_cap_edge, ship_cost = z(N, Dmax), z(N, P, Dmax)
    max_ship = np.where(has_supply.any(axis=1, keepdims=True), supply_cap,
                        0.0)
    has_ship = np.zeros((N, P), bool)
    for i, d in enumerate(dests):
        if d is None:
            continue
        for k, (dst, cap) in enumerate(zip(d[0], d[1])):
            edge_dst[i, k], edge_mask[i, k] = dst, True
            ship_cap_edge[i, k] = cap
            max_ship[dst] += cap
        for p in range(P):
            if stock_cap[i, p] > 0:
                has_ship[i, p] = True
                ship_cost[i, p, :len(d[0])] = d[2][p]

    sup_act_idx = -np.ones((N, P), np.int64)
    ship_act_idx = -np.ones((N, P, Dmax), np.int64)
    a = 0
    for i in range(N):
        for p in range(P):
            if has_supply[i, p]:
                sup_act_idx[i, p], a = a, a + 1
        if dests[i] is not None:
            for p in range(P):
                if has_ship[i, p]:
                    for k in range(n_dests[i]):
                        ship_act_idx[i, p, k], a = a, a + 1
    K = sum((P if has_supply[i].any() else 0) + int(n_dests[i])
            for i in range(N))
    lt_base, off = np.zeros(N, np.int64), 0
    for i in range(N):
        lt_base[i] = off
        off += int(has_supply[i].sum()) + (int(has_ship[i].sum())
                                           * int(n_dests[i])) // P

    stochastic = bool(chain.get("stochastic_leadtimes", False))
    Lavg = int(chain.get("avg_leadtime", 2))
    Lmax = int(chain.get("max_leadtime", 2))
    longest = max([len(row) for lists in inits for lst in lists
                   for row in lst] + [0])
    H = max(Lmax if stochastic else max(Lmax, Lavg), longest)
    init_pipe = z(H, N, P)
    for i, lists in enumerate(inits):
        for lst in lists:
            for p in range(P):
                for j, amount in enumerate(lst[p]):
                    init_pipe[j, i, p] += amount
    retailer_idx = np.nonzero(is_retailer)[0]
    R = len(retailer_idx)
    return Chain(
        N=N, P=P, R=R, A=a, K=K, T=int(T), Lavg=Lavg, Lmax=Lmax, H=H,
        Dmax=Dmax, obs_dim=R * P + N * P * (1 + Lavg) + 1,
        stochastic=stochastic, dem_min=float(lo), dem_max=float(hi),
        retailer_idx=retailer_idx, initial_stock=initial_stock,
        init_pipe=init_pipe, stock_cap=stock_cap, stock_cost=stock_cost,
        has_supply=has_supply, supply_cap=supply_cap, supply_cost=supply_cost,
        proc_cap=proc_cap, proc_cost=proc_cost, proc_ratio=proc_ratio,
        is_factory=is_factory, is_retailer=is_retailer, edge_dst=edge_dst,
        edge_mask=edge_mask, ship_cap_edge=ship_cap_edge,
        ship_cost=ship_cost, has_ship=has_ship, sup_act_idx=sup_act_idx,
        ship_act_idx=ship_act_idx, lt_base=lt_base, max_ship=max_ship,
        c_unmet=float(chain.get("unmet_demand_cost", 1000)),
        c_stock_pen=float(chain.get("exceeded_stock_capacity_cost", 1000)),
        c_proc_pen=float(chain.get("exceeded_process_capacity_cost", 1000)),
        c_ship_pen=float(chain.get("exceeded_ship_capacity_cost", 1000)))
