"""Batched supply-chain step engine in eager PyTorch.

The counterpart of ``gym_supplychain_tpu/core/step.py``: the whole batch of
environments advances in lockstep on dense tensors with the batch as the
trailing axis (``stock [N, P, B]``, ``pipe [H, N, P, B]``), the layout the
JAX package uses, so the tests compare like with like.  ``pipe[j]`` holds the
material arriving at ``t + 1 + j``.

This engine is the plain version the CUDA collect kernel is held against, so
every reduction that feeds the dynamics keeps a fixed order:

* the material leaving a node sums its destinations in index order;
* deliveries sum the incoming edges of each destination in edge order, then
  add once to the pipeline (``(pipe + supply) + (e1 + e2 + ...)``), with
  gathers instead of ``index_add_`` (atomics on CUDA) or a one-hot matmul;
* the last observation bucket sums its pipeline slots in slot order.

Action-facing arithmetic stays in the action's own dtype and promotes
afterwards, as the JAX engine does (its ``step_fn`` comments), so a float64
engine fed float32 actions reproduces the reference's float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .compile import CompiledChain

__all__ = ["EnvState", "StepOutput", "COST_KEYS", "chain_tables",
           "make_supplychain_kernels", "state_from_numpy", "state_to_numpy"]

COST_KEYS = ("stock", "stock_pen", "supply", "process", "process_pen",
             "ship", "ship_pen", "unmet_dem")


class EnvState(NamedTuple):
    """Per-episode state (batch is the trailing axis).

    Table mode carries whole-episode ``demands [T+1,R,P,B]`` and
    ``leadtimes [T,K,B]`` (None for constant lead-times) with ``ep_key``
    None; stateless mode carries the current demand row ``demands [R,P,B]``
    and the episode's Philox key ``ep_key = (k0, k1)``.  ``t`` is a Python
    int: the whole batch shares one clock.
    """
    t: int
    stock: torch.Tensor
    pipe: torch.Tensor
    demands: torch.Tensor
    leadtimes: Optional[torch.Tensor]
    ep_reward: torch.Tensor
    ep_costs: torch.Tensor
    ep_units: torch.Tensor
    ep_key: Optional[tuple] = None


class StepOutput(NamedTuple):
    obs: torch.Tensor         # [obs_dim, B] in [-1, 1]
    reward: torch.Tensor      # [B]
    done: bool
    costs: torch.Tensor       # [8, P, B]
    units: torch.Tensor       # [8, P, B]
    sup_push: Optional[torch.Tensor] = None   # [N, P, B] (debug kernels)
    sup_lt: Optional[torch.Tensor] = None     # [N, P, B]
    ship_push: Optional[torch.Tensor] = None  # [E, P, B]
    ship_lt: Optional[torch.Tensor] = None    # [E, B]


def chain_tables(cc: CompiledChain, device, dtype=torch.float32) -> dict:
    """The compiled chain's numpy tables as tensors on ``device``: floats in
    ``dtype``, masks as bool, indices as int64."""
    device = torch.device(device)

    def fl(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def bo(x):
        return torch.as_tensor(np.asarray(x, bool), device=device)

    def ix(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    e_src, e_di = np.nonzero(cc.edge_mask)
    max_ship = np.asarray(cc.max_ship, np.float64)
    return dict(
        retailer_idx=ix(cc.retailer_idx),
        initial_stock=fl(cc.initial_stock), init_pipe=fl(cc.init_pipe),
        stock_cap=fl(cc.stock_cap), stock_cost=fl(cc.stock_cost),
        has_supply=bo(cc.has_supply), supply_cap=fl(cc.supply_cap),
        supply_cost=fl(cc.supply_cost), proc_cap=fl(cc.proc_cap),
        proc_cost=fl(cc.proc_cost), proc_ratio=fl(cc.proc_ratio),
        is_factory=bo(cc.is_factory), edge_mask=bo(cc.edge_mask), ship_cap_edge=fl(cc.ship_cap_edge),
        ship_cost=fl(cc.ship_cost),
        has_ship=bo(np.asarray(cc.has_ship) & ~np.asarray(cc.is_retailer)[:, None]),
        sup_act_idx=ix(np.maximum(cc.sup_act_idx, 0)),
        ship_act_idx=ix(np.maximum(cc.ship_act_idx, 0)),
        lt_base=ix(cc.lt_base), max_ship=fl(max_ship),
        dem_min=fl(cc.dem_min), dem_range=fl(cc.dem_range),
        e_src=ix(e_src), e_di=ix(e_di),
    )


def _in_edge_index(cc: CompiledChain) -> np.ndarray:
    """``[max_in_degree, N]`` edge ids: row k holds the k-th incoming edge
    of each destination in edge order, or E (a zero row) past its degree."""
    e_src, e_di = np.nonzero(cc.edge_mask)
    e_dst = cc.edge_dst[e_src, e_di]
    E = len(e_dst)
    incoming = [[e for e in range(E) if e_dst[e] == n] for n in range(cc.N)]
    deg = max([len(x) for x in incoming] + [1])
    idx = np.full((deg, cc.N), E, np.int64)
    for n, es in enumerate(incoming):
        idx[:len(es), n] = es
    return idx


def make_supplychain_kernels(cc: CompiledChain, dtype=torch.float32,
                             debug: bool = False, stateless_rng: bool = False,
                             device="cpu"):
    """Build ``(reset_fn, step_fn, obs_fn)`` over a compiled chain.

    Table mode: ``reset_fn(demands, leadtimes, B)``.  Stateless mode
    (``stateless_rng=True``): ``reset_fn(key, B)`` with a Philox episode key
    ``(k0, k1)``; every step then draws its demand and lead-time rows from
    ``rng.device.stateless_step_rows``.  ``step_fn(state, action[A, B])``
    takes actions in [-1, 1].
    """
    from ..rng.device import stateless_step_rows

    device = torch.device(device)
    N, P, Dmax, R = cc.N, cc.P, cc.Dmax, cc.R
    Lavg, Lmax, H, T, K = cc.Lavg, cc.Lmax, cc.H, cc.T, cc.K
    tb = chain_tables(cc, device, dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    # normalizers computed in the engine dtype exactly as the JAX engine does
    ms_np = np.where(cc.max_ship > 0, cc.max_ship, 1.0).astype(np_dtype)
    ms = torch.as_tensor(ms_np, device=device)[:, :, None]
    ms_tail = torch.as_tensor(ms_np * np_dtype(Lmax - (Lavg - 1)),
                              device=device)[:, :, None]
    ms_ok = (tb["max_ship"] > 0)[:, :, None]
    cap_finite = torch.isfinite(tb["stock_cap"])[:, :, None]
    any_factory = bool(np.asarray(cc.is_factory).any())
    in_idx = torch.as_tensor(_in_edge_index(cc), device=device)
    didx = torch.arange(Dmax, device=device)
    Ls = torch.arange(1, Lmax + 1, device=device, dtype=torch.int32)
    ship_mask = (tb["has_ship"][:, :, None] & tb["edge_mask"][:, None, :])
    e_src, e_di = tb["e_src"], tb["e_di"]
    ridx = tb["retailer_idx"]

    def obs_fn(state: EnvState) -> torch.Tensor:
        B = state.stock.shape[-1]
        dem_row = state.demands if stateless_rng else state.demands[state.t]
        dem_obs = ((dem_row - tb["dem_min"][None, :, None])
                   / tb["dem_range"][None, :, None]).reshape(R * P, B)
        stock_obs = state.stock / tb["stock_cap"][:, :, None]
        buckets = [torch.where(ms_ok, state.pipe[j] / ms, 0.0)
                   for j in range(Lavg - 1)]
        tail = state.pipe[Lavg - 1]
        for j in range(Lavg, H):
            tail = tail + state.pipe[j]
        buckets.append(torch.where(ms_ok, tail / ms_tail, 0.0))
        transit = torch.stack(buckets, dim=2)                 # [N,P,Lavg,B]
        node_obs = torch.cat([stock_obs, transit.reshape(N, P * Lavg, B)], 1)
        # IEEE division on the host: PyTorch on CUDA divides by a Python
        # scalar through its reciprocal
        remaining = torch.full((1, B), float(np_dtype(T - state.t)
                                             / np_dtype(T)),
                               dtype=dtype, device=device)
        obs = torch.cat([dem_obs, node_obs.reshape(N * P * (1 + Lavg), B),
                         remaining], dim=0)
        return torch.clamp(2.0 * obs - 1.0, -1.0, 1.0)

    def _blank_state(demands, leadtimes, B, ep_key=None) -> EnvState:
        return EnvState(
            t=0,
            stock=tb["initial_stock"][:, :, None].expand(N, P, B).clone(),
            pipe=tb["init_pipe"][..., None].expand(H, N, P, B).clone(),
            demands=demands, leadtimes=leadtimes,
            ep_reward=torch.zeros((B,), dtype=dtype, device=device),
            ep_costs=torch.zeros((8, P, B), dtype=dtype, device=device),
            ep_units=torch.zeros((8, P, B), dtype=dtype, device=device),
            ep_key=ep_key)

    def reset_fn(demands, leadtimes, B: int) -> EnvState:
        """Fresh state from per-episode tables."""
        demands = torch.as_tensor(demands, dtype=dtype, device=device)
        if demands.ndim == 3:
            demands = demands[..., None].expand(T + 1, R, P, B)
        if cc.stochastic_leadtimes:
            leadtimes = torch.as_tensor(leadtimes, dtype=torch.int32,
                                        device=device)
            if leadtimes.ndim == 2:
                leadtimes = leadtimes[..., None].expand(T, K, B)
        else:
            leadtimes = None
        return _blank_state(demands, leadtimes, B)

    def reset_fn_stateless(key, B: int) -> EnvState:
        """Fresh state from a Philox episode key; demand row 0 drawn now."""
        key = (int(key[0]), int(key[1]))
        dem0, _ = stateless_step_rows(key, 0, cc, B, dtype, device)
        return _blank_state(dem0, None, B, ep_key=key)

    def _sorted_cut(v, s_g, adt):
        """Sorted-cut allocation (reference SC_Action.apply SHIP): v
        [N,P,D,B] action values, s_g [N,P,B] stock -> amounts [N,P,D,B]."""
        w = torch.full(v.shape, -torch.inf, dtype=adt, device=device)
        rank = torch.zeros(v.shape, dtype=torch.int64, device=device)
        d4 = didx[None, None, :, None]
        for j in range(Dmax):
            vj = v[:, :, j:j + 1, :]
            before = (vj < v) | ((vj == v) & (j < d4))
            w = torch.maximum(w, torch.where(before, vj, -torch.inf))
            rank = rank + before
        w = torch.where(rank == 0, 0.0, w)
        vdiff = v - w                                         # adt
        cut = vdiff.to(dtype) * s_g[:, :, None]
        if adt != dtype:
            # stock exactly at capacity: the reference multiplies the action
            # dtype by the int capacity and stays in the action dtype
            at_cap = (s_g == tb["stock_cap"][:, :, None])[:, :, None]
            cut_raw = (vdiff * s_g.to(adt)[:, :, None]).to(dtype)
            cut = torch.where(at_cap, cut_raw, cut)
        availr = s_g
        amounts = torch.zeros(cut.shape, dtype=dtype, device=device)
        for k in range(Dmax):
            # exactly one destination has rank k, so these sums are exact
            sel = rank == k
            cut_k = torch.where(sel, cut, 0.0).sum(dim=2)
            amt_k = torch.minimum(cut_k, availr)
            availr = availr - amt_k
            amounts = amounts + torch.where(sel, amt_k[:, :, None], 0.0)
        return amounts

    def _deliver(x):
        """x [..., E, P, B] per-edge pushes -> [..., N, P, B] per-destination
        sums over incoming edges in edge order."""
        xz = torch.cat([x, torch.zeros_like(x.narrow(-3, 0, 1))], dim=-3)
        add = xz.index_select(-3, in_idx[0])
        for k in range(1, in_idx.shape[0]):
            add = add + xz.index_select(-3, in_idx[k])
        return add

    def step_fn(state: EnvState, action: torch.Tensor):
        action = torch.as_tensor(action, device=device)
        B = action.shape[-1]
        adt = action.dtype if action.is_floating_point() else dtype
        a = (action.to(adt) + 1) * 0.5
        t = state.t + 1
        if stateless_rng:
            dem_next, lt_row_sl = stateless_step_rows(state.ep_key, t, cc, B,
                                                      dtype, device)
        a_sup = torch.where(tb["has_supply"][:, :, None],
                            a[tb["sup_act_idx"]], 0.0)            # [N,P,B]
        a_shp = torch.where(ship_mask[..., None], a[tb["ship_act_idx"]],
                            0.0)                                  # [N,P,D,B]
        costs, units = {}, {}

        # phase 1: arrivals
        pipe = torch.cat([state.pipe[1:], torch.zeros_like(state.pipe[:1])])
        stock = state.stock + state.pipe[0]

        # phase 2: stock-capacity overflow
        cap = tb["stock_cap"][:, :, None]
        excess = torch.where(cap_finite, torch.clamp_min(stock - cap, 0.0),
                             0.0)
        units["stock_pen"] = excess.sum(0)
        costs["stock_pen"] = cc.c_stock_pen * units["stock_pen"]
        stock = torch.minimum(stock, cap)

        # phase 3: supply, amount and cost in the action dtype
        sup_amt_raw = a_sup * tb["supply_cap"].to(adt)[:, :, None]
        sup_amt = sup_amt_raw.to(dtype)
        fired = tb["has_supply"][:, :, None] & (sup_amt > 0)
        costs["supply"] = (sup_amt_raw * tb["supply_cost"].to(adt)[:, :, None]
                           ).to(dtype).sum(0)
        units["supply"] = sup_amt.sum(0)
        if cc.stochastic_leadtimes:
            lt_row = lt_row_sl if stateless_rng else state.leadtimes[t - 1]
            # supply column = base + #earlier fired supplies at the node;
            # transport columns follow the fired supplies, one per
            # destination, shared across products
            fired_i = fired.to(torch.int64)
            rank = torch.cumsum(fired_i, dim=1) - fired_i
            col = torch.clamp(tb["lt_base"][:, None, None] + rank, 0, K - 1)
            lt_sup = torch.gather(lt_row, 0, col.reshape(N * P, B)
                                  ).reshape(N, P, B)
            n_fired = fired_i.sum(dim=1)                          # [N,B]
            col = torch.clamp(tb["lt_base"][:, None, None] + n_fired[:, None, :]
                              + didx[None, :, None], 0, K - 1)
            lt_shp = torch.gather(lt_row, 0, col.reshape(N * Dmax, B)
                                  ).reshape(N, Dmax, B)
            contrib_l = torch.where(
                fired[None] & (lt_sup[None] == Ls[:, None, None, None]),
                sup_amt[None], 0.0)                              # [Lmax,N,P,B]
            pipe[:Lmax] += contrib_l
        else:
            lt_sup = torch.full((N, P, B), Lavg, dtype=torch.int32,
                                device=device)
            lt_shp = torch.full((N, Dmax, B), Lavg, dtype=torch.int32,
                                device=device)
            pipe[Lavg - 1] += torch.where(fired, sup_amt, 0.0)

        # phase 4: ship, the product loop carries the shared processing and
        # per-destination ship capacities
        avail_proc = tb["proc_cap"][:, None].expand(N, B)
        avail_ship = tb["ship_cap_edge"][:, :, None].expand(N, Dmax, B)
        amounts_all = torch.where(tb["edge_mask"][:, None, :, None],
                                  _sorted_cut(a_shp, stock, adt), 0.0)
        is_fac = tb["is_factory"]
        new_stock_cols, pushes = [], []
        per_p = {k: [] for k in ("process", "process_pen", "ship_pen", "ship")}
        per_pu = {k: [] for k in per_p}
        lt_e = lt_shp[e_src, e_di]                                # [E,B]
        for p in range(P):
            avail_mat = stock[:, p]
            amounts = amounts_all[:, p]                           # [N,D,B]
            ratio = tb["proc_ratio"][:, p, None, None]
            exc_proc = torch.zeros((N, B), dtype=dtype, device=device)
            if any_factory:
                # processing-capacity clip, sequential over destinations
                clipped = []
                for i in range(Dmax):
                    ai = amounts[:, i]
                    gate = is_fac[:, None] & (ai > 0)
                    over = gate & (ai > avail_proc)
                    exc_proc = exc_proc + torch.where(over, ai - avail_proc,
                                                      0.0)
                    ai2 = torch.where(over, avail_proc, ai)
                    avail_proc = avail_proc - torch.where(gate, ai2, 0.0)
                    clipped.append(ai2)
                amounts = torch.stack(clipped, dim=1)
                to_ship = torch.where(is_fac[:, None, None], amounts / ratio,
                                      amounts)
            else:
                to_ship = amounts
            # ship-capacity clip, bug-compatible: the shared capacity drops
            # only in the over-capacity branch, by the raw amount
            a2 = to_ship
            gate2 = (a2 > 0) & (a2 > avail_ship)
            exc_ship = torch.where(gate2, a2 - avail_ship, 0.0).sum(dim=1)
            a2c = torch.where(gate2, avail_ship, a2)
            raw = torch.where(gate2,
                              torch.where(is_fac[:, None, None], a2c * ratio,
                                          a2c),
                              amounts)
            avail_ship = avail_ship - torch.where(gate2, raw, 0.0)
            leaving = raw[:, 0]
            for d in range(1, Dmax):
                leaving = leaving + raw[:, d]
            new_stock_cols.append(avail_mat - leaving)
            fac_leaving = torch.where(is_fac[:, None], leaving, 0.0)
            per_p["process"].append(
                torch.where(is_fac[:, None],
                            leaving * tb["proc_cost"][:, p, None], 0.0).sum(0))
            per_pu["process"].append(fac_leaving.sum(0))
            per_pu["process_pen"].append(exc_proc.sum(0))
            per_p["process_pen"].append(cc.c_proc_pen * per_pu["process_pen"][-1])
            per_pu["ship_pen"].append(exc_ship.sum(0))
            per_p["ship_pen"].append(cc.c_ship_pen * per_pu["ship_pen"][-1])
            per_p["ship"].append((a2c * tb["ship_cost"][:, p, :, None]
                                  ).sum(dim=(0, 1)))
            per_pu["ship"].append(a2c.sum(dim=(0, 1)))
            pushes.append(a2c[e_src, e_di])                       # [E,B]
        for k in per_p:
            costs[k] = torch.stack(per_p[k])
            units[k] = torch.stack(per_pu[k])
        stock = torch.stack(new_stock_cols, dim=1)

        # deliver into destination pipelines (push only if > 0)
        contrib_ep = torch.stack(pushes, dim=1)                   # [E,P,B]
        pos = contrib_ep > 0
        if cc.stochastic_leadtimes:
            masked = torch.where(
                pos[None] & (lt_e[None, :, None, :]
                             == Ls[:, None, None, None]),
                contrib_ep[None], 0.0)                            # [Lmax,E,P,B]
            pipe[:Lmax] += _deliver(masked)
        else:
            pipe[Lavg - 1] += _deliver(torch.where(pos, contrib_ep, 0.0))

        # phase 5: retailer demand
        dem_row = state.demands if stateless_rng else state.demands[t - 1]
        r_stock = stock[ridx]
        fulfilled = torch.minimum(r_stock, dem_row)
        stock[ridx] = r_stock - fulfilled
        units["unmet_dem"] = (dem_row - fulfilled).sum(0)
        costs["unmet_dem"] = cc.c_unmet * units["unmet_dem"]

        # phase 6: holding costs
        costs["stock"] = (stock * tb["stock_cost"][:, :, None]).sum(0)
        units["stock"] = stock.sum(0)

        cost_mat = torch.stack([costs[k] for k in COST_KEYS])     # [8,P,B]
        unit_mat = torch.stack([units[k] for k in COST_KEYS])
        reward = -cost_mat.sum(dim=(0, 1))
        new_state = EnvState(
            t=t, stock=stock, pipe=pipe,
            demands=dem_next if stateless_rng else state.demands,
            leadtimes=state.leadtimes,
            ep_reward=state.ep_reward + reward,
            ep_costs=state.ep_costs + cost_mat,
            ep_units=state.ep_units + unit_mat,
            ep_key=state.ep_key)
        out = StepOutput(obs=obs_fn(new_state), reward=reward, done=t == T,
                         costs=cost_mat, units=unit_mat)
        if debug:
            out = out._replace(sup_push=torch.where(fired, sup_amt, 0.0),
                               sup_lt=lt_sup, ship_push=contrib_ep,
                               ship_lt=lt_e)
        return new_state, out

    return (reset_fn_stateless if stateless_rng else reset_fn), step_fn, obs_fn


def state_from_numpy(d: dict, device="cpu"):
    """A state from numpy arrays keyed by the JAX field names: an
    ``EnvState``, or a ``BeerGameState`` when ``d`` has a ``week``."""
    from .beergame import BeerGameState

    cls = BeerGameState if "week" in d else EnvState
    clock = "week" if cls is BeerGameState else "t"
    kw = {}
    for f in cls._fields:
        v = d.get(f)
        if f == clock:
            kw[f] = int(np.asarray(v))
        elif f == "ep_key":
            kw[f] = None if v is None else tuple(int(x) for x in np.asarray(v))
        else:
            kw[f] = None if v is None else torch.as_tensor(np.array(v),
                                                           device=device)
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """The inverse of ``state_from_numpy``."""
    out = {}
    for f, v in state._asdict().items():
        if isinstance(v, torch.Tensor):
            out[f] = v.detach().cpu().numpy()
        elif f in ("t", "week"):
            out[f] = np.int32(v)
        elif f == "ep_key" and v is not None:
            out[f] = np.asarray(v, np.uint32)
        else:
            out[f] = v
    return out
