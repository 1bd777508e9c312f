"""Topology compiler: ``nodes_info`` dict -> static dense arrays (``CompiledChain``).

Vendored, unchanged, from ``gym_supplychain_tpu/core/compile.py``: the module
is numpy-only, but importing it from the JAX package would import jax through
``gym_supplychain_tpu/__init__.py``.  ``tests/test_torch_compile.py`` holds the
two copies equal field by field.

This replaces the reference's object-wiring construction stack
(``SupplyChainEnv.__init__`` -> ``create_nodes`` -> ``SC_Node.__init__`` /
``define_destinations``, reference supplychain_env.py:482-626) with a purely
static compilation step.  The output is a bundle of NumPy arrays describing the
chain topology, capacities, costs, action/lead-time index maps and observation
normalizers.  A jitted TPU step kernel closes over these arrays as compile-time
constants; nothing here is traced.

Schema parity: the ``nodes_info`` dict uses exactly the reference's keys
(``initial_stock``, ``initial_supply``, ``initial_shipments``,
``stock_capacity``, ``stock_cost``, ``supply_capacity``, ``supply_cost``,
``processing_capacity``, ``processing_cost``, ``destinations``, ``dest_costs``,
``ship_capacity``, ``last_level``; reference supplychain_env.py:499-554) and the
env-level keyword arguments mirror ``SupplyChainEnv.__init__``
(supplychain_env.py:482-489).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CompiledChain", "compile_chain", "DemandConfig"]


def _int_or_list(param, num_products: int, default_value: int = 0):
    """Broadcast an int to a per-product list; validate list length.

    Mirrors ``SC_Node._treat_int_or_list_param`` (reference
    supplychain_env.py:178-191) including its rejection of non-int scalars
    (so ``float('inf')`` stock capacity raises, as it does upstream).
    """
    if type(param) is list:
        if len(param) > 0:
            if len(param) != num_products:
                raise AssertionError(
                    f"list param {param!r} must have one value per product ({num_products})")
        else:
            param = [default_value] * num_products
    elif type(param) is int:
        param = [param] * num_products
    else:
        raise ValueError(
            f"Invalid param: '{param}' should be an int or a list with one value per product")
    return list(param)


@dataclasses.dataclass(frozen=True)
class DemandConfig:
    """Per-product (or shared) demand process parameters.

    Mirrors the reference's demand kwargs (supplychain_env.py:566-595) and the
    generator dispatch in demands_generator.py:3-31:
    ``sen_peaks is None and std is None`` -> uniform ints in [minv, maxv];
    ``sen_peaks is None`` -> normal(mid, std) clipped + rint;
    else sinusoidal base in [minavg, maxavg] with ``sen_peaks`` peaks plus a
    normal(0, std) or uniform [-3 std, 3 std] perturbation, clipped + rint.
    """
    minv: int
    maxv: int
    std: Optional[float] = None
    sen_peaks: Optional[int] = None
    minavg: Optional[float] = None
    maxavg: Optional[float] = None
    perturb_norm: bool = False


@dataclasses.dataclass(frozen=True)
class CompiledChain:
    """Static description of a supply-chain environment.

    All arrays are NumPy; shapes use N=#nodes, P=#products, R=#retailers,
    Dmax=max out-degree, H=pipeline horizon, A=action dim, K=lead-time columns.
    """
    # --- sizes -----------------------------------------------------------
    node_names: Tuple[str, ...]
    N: int
    P: int
    R: int
    A: int
    K: int                       # lead-time table columns drawn per step
    T: int                       # total_time_steps
    Lavg: int                    # avg_leadtime (also obs bucket count)
    Lmax: int                    # max_leadtime
    H: int                       # pipeline ring length (>= Lmax, >= init horizon)
    Dmax: int
    obs_dim: int
    stochastic_leadtimes: bool
    demand_by_product: bool

    # --- per-node / per-product tables ----------------------------------
    is_retailer: np.ndarray      # [N] bool
    retailer_idx: np.ndarray     # [R] int
    initial_stock: np.ndarray    # [N,P] f64
    init_pipe: np.ndarray        # [H,N,P] f64 (initial_supply + initial_shipments at t=1..)
    stock_cap: np.ndarray        # [N,P] f64 (may be inf)
    stock_cost: np.ndarray       # [N,P] f64
    has_supply: np.ndarray       # [N,P] bool
    supply_cap: np.ndarray       # [N,P] f64
    supply_cost: np.ndarray      # [N,P] f64
    proc_cap: np.ndarray         # [N] f64 (shared across products)
    proc_cost: np.ndarray        # [N,P] f64
    proc_ratio: np.ndarray       # [N,P] f64 (1 where not a factory, for safe div)
    is_factory: np.ndarray       # [N] bool (processing_capacity > 0)

    # --- edges -----------------------------------------------------------
    has_dests: np.ndarray        # [N] bool
    n_dests: np.ndarray          # [N] int
    edge_dst: np.ndarray         # [N,Dmax] int (pad 0)
    edge_mask: np.ndarray        # [N,Dmax] bool
    ship_cap_edge: np.ndarray    # [N,Dmax] f64 (per-destination shared capacity)
    ship_cost: np.ndarray        # [N,P,Dmax] f64
    has_ship: np.ndarray         # [N,P] bool (node has dests and stock_cap[p] > 0)

    # --- action / lead-time index maps ----------------------------------
    sup_act_idx: np.ndarray      # [N,P] int (-1 where no supply action)
    ship_act_idx: np.ndarray     # [N,P,Dmax] int (-1 pad)
    lt_base: np.ndarray          # [N] int, first lead-time column of node n

    # --- observation normalizers ----------------------------------------
    max_ship: np.ndarray         # [N,P] f64

    # --- env-level scalars ----------------------------------------------
    c_unmet: float
    c_stock_pen: float
    c_proc_pen: float
    c_ship_pen: float

    # --- demand processes ------------------------------------------------
    demand: Tuple[DemandConfig, ...]   # len 1 (shared) or P (by-product)
    dem_min: np.ndarray          # [P] f64 (obs normalizer offset)
    dem_range: np.ndarray        # [P] f64 (obs normalizer scale)

    # --- reset-time pipeline pushes in exact reference order --------------
    # per node: ((prod, time, amount), ...) — initial_supply then
    # initial_shipments, product-major, arriving at t=1.. (reference
    # SC_Node.reset, supplychain_env.py:402-412).  Feeds the strict-parity
    # heap mirror; the dense init_pipe above is its aggregation.
    init_push_seq: Tuple[Tuple[Tuple[int, int, float], ...], ...] = ()

    def node_index(self, name: str) -> int:
        return self.node_names.index(name)


def compile_chain(nodes_info: Dict[str, Dict[str, Any]],
                  num_products: int = 1,
                  unmet_demand_cost: float = 1000,
                  exceeded_stock_capacity_cost: float = 1000,
                  exceeded_process_capacity_cost: float = 1000,
                  exceeded_ship_capacity_cost: float = 1000,
                  demand_config_by_product: bool = False,
                  demand_range=(10, 20),
                  demand_std=None,
                  demand_sen_peaks=None,
                  avg_demand_range=None,
                  processing_ratio=3,
                  stochastic_leadtimes: bool = False,
                  avg_leadtime: int = 2,
                  max_leadtime: int = 2,
                  total_time_steps: int = 360,
                  demand_perturb_norm=False) -> CompiledChain:
    """Compile a reference-schema ``nodes_info`` dict into dense arrays.

    Node order is dict insertion order, which fixes the action-vector,
    observation and lead-time-column layouts exactly as in the reference
    (supplychain_env.py:607-626, :714-724).
    """
    P = num_products
    names = tuple(nodes_info.keys())
    N = len(names)
    name_to_idx = {n: i for i, n in enumerate(names)}

    is_retailer = np.zeros(N, bool)
    initial_stock = np.zeros((N, P))
    stock_cap = np.zeros((N, P))
    stock_cost = np.zeros((N, P))
    has_supply = np.zeros((N, P), bool)
    supply_cap = np.zeros((N, P))
    supply_cost = np.zeros((N, P))
    proc_cap = np.zeros(N)
    proc_cost = np.zeros((N, P))
    proc_ratio = np.ones((N, P))
    init_supply_lists = [None] * N
    init_ship_lists = [None] * N
    dests: list = [None] * N
    ship_caps_by_dest: list = [None] * N
    ship_costs_by_prod: list = [None] * N

    for i, name in enumerate(names):
        info = nodes_info[name]
        processing_cost = info.get('processing_cost', 0)
        # processing_ratio is zeroed for nodes without processing cost
        # (reference supplychain_env.py:518-522)
        if ((type(processing_cost) is int and processing_cost == 0)
                or (type(processing_cost) is list and sum(processing_cost) == 0)):
            node_proc_ratio = 0
        else:
            node_proc_ratio = processing_ratio

        initial_stock[i] = _int_or_list(info.get('initial_stock', 0), P)
        # stock_capacity default is float('inf') which the reference's own
        # param validation rejects (supplychain_env.py:529 + :178-191); keep
        # identical behavior so misconfigurations fail the same way.
        stock_cap[i] = _int_or_list(info.get('stock_capacity', float('inf')), P)
        stock_cost[i] = _int_or_list(info.get('stock_cost', 0), P)
        scap = _int_or_list(info.get('supply_capacity', 0), P)
        scost = _int_or_list(info.get('supply_cost', 0), P)
        supply_cap[i] = scap
        supply_cost[i] = scost
        if max(scap) > 0:
            has_supply[i] = np.asarray(scap) > 0
        proc_cap[i] = info.get('processing_capacity', 0)
        proc_cost[i] = _int_or_list(processing_cost, P)
        proc_ratio[i] = _int_or_list(node_proc_ratio, P)
        is_retailer[i] = bool(info.get('last_level', False))
        init_supply_lists[i] = info.get('initial_supply', None)
        init_ship_lists[i] = info.get('initial_shipments', None)
        if 'destinations' in info:
            dests[i] = [name_to_idx[d] for d in info['destinations']]
            ship_caps_by_dest[i] = list(info['ship_capacity'])
            ship_costs_by_prod[i] = [list(c) for c in info['dest_costs']]

    is_factory = proc_cap > 0
    # The reference divides shipments by processing_ratio whenever
    # processing_capacity > 0 (supplychain_env.py:298-310) but zeroes the
    # ratio when processing_cost == 0 (:518-522) — that combination divides
    # by zero upstream (inf/ZeroDivisionError).  Reject it loudly instead of
    # silently diverging.
    for i, name in enumerate(names):
        if proc_cap[i] > 0 and (proc_ratio[i] == 0).any():
            raise ValueError(
                f"node {name!r}: processing_capacity > 0 with a zero "
                "processing ratio (processing_cost == 0 zeroes it, reference "
                "supplychain_env.py:518-522) makes the reference divide "
                "shipments by zero (:310); set a processing_cost or drop "
                "the processing_capacity")
    # where not a factory, ratio stays at its configured value but is never
    # used for division; replace zeros with 1 for safe vectorized division.
    safe_ratio = np.where(proc_ratio == 0, 1.0, proc_ratio)

    has_dests = np.array([d is not None for d in dests])
    n_dests = np.array([len(d) if d else 0 for d in dests])
    Dmax = max(1, int(n_dests.max()) if N else 1)
    edge_dst = np.zeros((N, Dmax), np.int32)
    edge_mask = np.zeros((N, Dmax), bool)
    ship_cap_edge = np.zeros((N, Dmax))
    ship_cost = np.zeros((N, P, Dmax))
    # Observation normalizer: suppliers start from their supply capacities,
    # every destination accumulates incoming ship capacity
    # (reference supplychain_env.py:145-152, :203-206).
    max_ship = np.where(has_supply.any(axis=1, keepdims=True), supply_cap, 0.0)
    has_ship = np.zeros((N, P), bool)
    for i in range(N):
        if dests[i] is None:
            continue
        for di, d in enumerate(dests[i]):
            edge_dst[i, di] = d
            edge_mask[i, di] = True
            ship_cap_edge[i, di] = ship_caps_by_dest[i][di]
            max_ship[d, :] += ship_caps_by_dest[i][di]
        for p in range(P):
            if stock_cap[i, p] > 0:
                has_ship[i, p] = True
                for di in range(len(dests[i])):
                    ship_cost[i, p, di] = ship_costs_by_prod[i][p][di]

    # --- action vector layout (insertion order; supply block then per-product
    # ship blocks; reference supplychain_env.py:243-250, :272-296, :372) -----
    sup_act_idx = -np.ones((N, P), np.int32)
    ship_act_idx = -np.ones((N, P, Dmax), np.int32)
    a = 0
    for i in range(N):
        for p in range(P):
            if has_supply[i, p]:
                sup_act_idx[i, p] = a
                a += 1
        if dests[i] is not None:
            for p in range(P):
                if has_ship[i, p]:
                    for di in range(len(dests[i])):
                        ship_act_idx[i, p, di] = a
                        a += 1
    A = a

    # --- lead-time table layout -----------------------------------------
    # Total columns drawn per step (reference supplychain_env.py:597-605):
    # num_products per supplying node (regardless of how many products have
    # capacity) plus one per destination link.
    K = 0
    for i in range(N):
        if has_supply[i].any():
            K += P
        K += int(n_dests[i])
    # Column offsets actually consumed per node use a different width:
    # num_supply_actions + num_ship_actions // P (supplychain_env.py:719-722).
    lt_base = np.zeros(N, np.int32)
    off = 0
    for i in range(N):
        lt_base[i] = off
        n_sup = int(has_supply[i].sum())
        n_ship_actions = int(has_ship[i].sum()) * int(n_dests[i])
        off += n_sup + n_ship_actions // P

    retailer_idx = np.nonzero(is_retailer)[0].astype(np.int32)
    R = len(retailer_idx)

    # --- demand configs ---------------------------------------------------
    def _mk_dem(rng, std, peaks, avg_rng, pnorm):
        minavg = maxavg = None
        if avg_rng:
            minavg, maxavg = avg_rng[0], avg_rng[1]
        return DemandConfig(minv=rng[0], maxv=rng[1], std=std, sen_peaks=peaks,
                            minavg=minavg, maxavg=maxavg, perturb_norm=bool(pnorm))

    if not demand_config_by_product:
        assert demand_range[0] != demand_range[1], "fixed demand unsupported (reference :589-595)"
        demand = ( _mk_dem(demand_range, demand_std, demand_sen_peaks,
                           avg_demand_range, demand_perturb_norm), )
        dem_min = np.full(P, float(demand_range[0]))
        dem_rng = np.full(P, float(demand_range[1] - demand_range[0]))
    else:
        cfgs = []
        dem_min = np.zeros(P)
        dem_rng = np.zeros(P)
        for p in range(P):
            assert demand_range[p][0] != demand_range[p][1]
            cfgs.append(_mk_dem(demand_range[p], demand_std[p], demand_sen_peaks[p],
                                avg_demand_range[p], demand_perturb_norm[p]))
            dem_min[p] = demand_range[p][0]
            dem_rng[p] = demand_range[p][1] - demand_range[p][0]
        demand = tuple(cfgs)

    # --- initial pipeline -------------------------------------------------
    # initial_supply/initial_shipments arrive at t=1..len (reference :402-417).
    max_init = 0
    for lst in list(init_supply_lists) + list(init_ship_lists):
        if lst:
            for per_prod in lst:
                max_init = max(max_init, len(per_prod))
    # Constant mode ships at t+avg_leadtime regardless of max_leadtime (the
    # reference's heaps accept any arrival time, supplychain_env.py:398-400,
    # :723-724); stochastic draws are clipped to [1, max_leadtime].  Size the
    # dense pipeline for whichever applies so no material can fall off.
    eff_lead = max_leadtime if stochastic_leadtimes \
        else max(max_leadtime, avg_leadtime)
    H = max(eff_lead, max_init)
    init_pipe = np.zeros((H, N, P))
    init_push_seq = []
    for i in range(N):
        pushes = []
        for lst in (init_supply_lists[i], init_ship_lists[i]):
            if not lst:
                continue
            for p in range(P):
                for j, amt in enumerate(lst[p]):
                    init_pipe[j, i, p] += amt
                    pushes.append((p, j + 1, float(amt)))
        init_push_seq.append(tuple(pushes))

    obs_dim = R * P + N * P + N * P * avg_leadtime + 1

    return CompiledChain(
        node_names=names, N=N, P=P, R=R, A=A, K=K, T=total_time_steps,
        Lavg=avg_leadtime, Lmax=max_leadtime, H=H, Dmax=Dmax, obs_dim=obs_dim,
        stochastic_leadtimes=bool(stochastic_leadtimes),
        demand_by_product=bool(demand_config_by_product),
        is_retailer=is_retailer, retailer_idx=retailer_idx,
        initial_stock=initial_stock, init_pipe=init_pipe,
        stock_cap=stock_cap, stock_cost=stock_cost,
        has_supply=has_supply, supply_cap=supply_cap, supply_cost=supply_cost,
        proc_cap=proc_cap, proc_cost=proc_cost, proc_ratio=safe_ratio,
        is_factory=is_factory,
        has_dests=has_dests, n_dests=n_dests, edge_dst=edge_dst,
        edge_mask=edge_mask, ship_cap_edge=ship_cap_edge, ship_cost=ship_cost,
        has_ship=has_ship,
        sup_act_idx=sup_act_idx, ship_act_idx=ship_act_idx, lt_base=lt_base,
        max_ship=max_ship,
        c_unmet=float(unmet_demand_cost),
        c_stock_pen=float(exceeded_stock_capacity_cost),
        c_proc_pen=float(exceeded_process_capacity_cost),
        c_ship_pen=float(exceeded_ship_capacity_cost),
        demand=demand, dem_min=dem_min, dem_range=dem_rng,
        init_push_seq=tuple(init_push_seq),
    )
