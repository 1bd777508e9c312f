"""Scripted base-stock baselines for the supply-chain family.

The counterpart of the supply-chain half of
``gym_supplychain_tpu/learn/heuristics.py``: an order-up-to ("base-stock")
policy that observes the true env state (stock and in-transit pipeline), the
standard OR baseline a trained policy has to beat.  Per node and product:

* supply nodes order up to a target inventory position:
  ``order = clip(target - (stock + in_transit), 0, supply_cap)``;
* every node with destinations ships each destination the amount that would
  restore the destination's inventory position to its target (factories
  ship raw material scaled by their processing ratio), scaled down
  proportionally when the requests exceed the node's stock.

The per-destination fractions enter the sorted-cut action convention as
cumulative sums over the destination axis.  Targets default to ``z *
mean_demand * reachable_retailers * (Lavg + 1)`` (times the processing
ratio at factories), and ``best_base_stock`` grid-searches ``z``.  The
policy reads the state, not the observation, so it runs as plain PyTorch
over the batched env (as the JAX package runs it over its env): no kernel
applies.

The beer game's order-up-to baseline (``make_beergame_base_stock_policy``,
``beergame_base_stock_runner``, ``best_beergame_base_stock``) orders each
level up to a target inventory position, reading the true
``BeerGameState`` on the eager engine.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..envs.vector import _as_key, beergame_table_config, make_vec_env

__all__ = ["mean_demand", "default_base_stock_targets",
           "make_base_stock_policy", "evaluate_state_policy",
           "best_base_stock", "make_beergame_base_stock_policy",
           "beergame_base_stock_runner", "best_beergame_base_stock"]


def mean_demand(cc: CompiledChain) -> np.ndarray:
    """Expected per-retailer per-step demand [P] for each product's process
    (uniform midpoint / normal midpoint / seasonal average base)."""
    out = np.zeros(cc.P)
    for p in range(cc.P):
        cfg = cc.demand[p if cc.demand_by_product else 0]
        if cfg.sen_peaks is None:
            out[p] = (cfg.minv + cfg.maxv) / 2.0
        else:
            out[p] = (cfg.minavg + cfg.maxavg) / 2.0
    return out


def _reachable_retailers(cc: CompiledChain) -> np.ndarray:
    """Number of distinct retailers reachable from each node [N], iterated
    over the graph to a fixed point (set-based: parallel paths must not
    multiply the count)."""
    ret_bit = {int(r): 1 << i
               for i, r in enumerate(np.asarray(cc.retailer_idx))}
    reach = np.array([ret_bit.get(n, 0) for n in range(cc.N)], object)
    for _ in range(cc.N):
        nxt = reach.copy()
        for n in range(cc.N):
            if cc.is_retailer[n]:
                continue
            mask = 0
            for d in range(cc.Dmax):
                if cc.edge_mask[n, d]:
                    mask |= reach[cc.edge_dst[n, d]]
            nxt[n] = mask
        if np.array_equal(nxt, reach):
            break
        reach = nxt
    return np.array([bin(m).count("1") for m in reach], np.int64)


def default_base_stock_targets(cc: CompiledChain, z: float = 1.0) -> np.ndarray:
    """Order-up-to targets [N, P]: z * lead-time demand served by the node,
    raw material at factories, never past the stock capacity."""
    md = mean_demand(cc)                                   # [P]
    reach = _reachable_retailers(cc).astype(np.float64)    # [N]
    targets = z * (cc.Lavg + 1) * reach[:, None] * md[None, :]
    targets = np.where(cc.is_factory[:, None], targets * cc.proc_ratio, targets)
    return np.minimum(targets, np.asarray(cc.stock_cap))


def make_base_stock_policy(cc: CompiledChain, targets,
                           dtype=torch.float32) -> Callable:
    """Returns ``policy(env_state) -> action [A, B]`` in [-1, 1] over the
    port's ``EnvState``; ``targets [N, P]`` is an array or a tensor, put with
    the chain's constants on the state's device at the first call there."""
    supply_cap = np.asarray(cc.supply_cap, np.float64)
    safe_sup = np.where(supply_cap > 0, supply_cap, 1.0)
    sup_rows, sup_prods = np.nonzero(np.asarray(cc.has_supply))
    sup_idx = cc.sup_act_idx[sup_rows, sup_prods]
    has_ship = np.asarray(cc.has_ship) & (~cc.is_retailer[:, None])
    shp_n, shp_p, shp_d = np.nonzero(has_ship[:, :, None]
                                     & cc.edge_mask[:, None, :])
    shp_idx = cc.ship_act_idx[shp_n, shp_p, shp_d]
    consts = {}

    def _on(device, sdt):
        """The chain's constants on ``device`` (built once per device)."""
        if device not in consts:
            f = dict(dtype=sdt, device=device)
            ix = dict(dtype=torch.int64, device=device)
            consts[device] = dict(
                tgt=torch.as_tensor(targets, **f)[:, :, None],
                cap=torch.as_tensor(supply_cap, **f)[:, :, None],
                safe=torch.as_tensor(safe_sup, **f)[:, :, None],
                ratio=torch.as_tensor(np.asarray(cc.proc_ratio), **f
                                      )[:, :, None, None],
                dst=torch.as_tensor(np.asarray(cc.edge_dst), **ix),
                emask=torch.as_tensor(np.asarray(cc.edge_mask),
                                      device=device)[:, :, None, None],
                sup=[torch.as_tensor(x, **ix) for x in
                     (sup_idx, sup_rows, sup_prods)],
                shp=[torch.as_tensor(x, **ix) for x in
                     (shp_idx, shp_n, shp_p, shp_d)])
        return consts[device]

    def policy(env_state) -> torch.Tensor:
        stock = env_state.stock                        # [N,P,B]
        B = stock.shape[-1]
        c = _on(stock.device, stock.dtype)
        ip = stock + env_state.pipe.sum(dim=0)         # inventory position
        tgt = c["tgt"]

        # supply: order up to target, as a fraction of supply capacity
        order = torch.minimum(torch.clamp_min(tgt - ip, 0.0), c["cap"])
        v_sup = order / c["safe"]                      # [N,P,B] in [0,1]

        # ship: requested replenishment of each destination, in this node's
        # stock units (factories: raw = product * ratio)
        deficit = torch.clamp_min(tgt - ip, 0.0)       # [N,P,B]
        want = deficit[c["dst"]]                       # [N,Dmax,P,B]
        want = torch.where(c["emask"], want, 0.0)
        want = want.permute(0, 2, 1, 3)                # [N,P,Dmax,B]
        want = want * c["ratio"]
        total = want.sum(dim=2, keepdim=True)          # [N,P,1,B]
        avail = torch.clamp_min(stock[:, :, None, :], 0.0)
        scale = torch.where(total > avail,
                            avail / torch.where(total > 0, total, 1.0), 1.0)
        frac = torch.where(avail > 0,
                           want * scale / torch.where(avail > 0, avail, 1.0),
                           0.0)                        # [N,P,Dmax,B]
        # cumulative sums over destinations: sorted consecutive differences
        # are the fractions, the max the total shipped fraction
        v_shp = torch.clamp(torch.cumsum(frac, dim=2), 0.0, 1.0)

        a = torch.zeros((cc.A, B), dtype=stock.dtype, device=stock.device)
        si, sr, sp = c["sup"]
        a[si] = v_sup[sr, sp]
        hi, hn, hp, hd = c["shp"]
        a[hi] = v_shp[hn, hp, hd]
        return (2.0 * a - 1.0).to(dtype)

    return policy


def _base_stock_runner(cc: CompiledChain, batch_size: int, episodes: int,
                       dtype, device):
    """``run(targets, key) -> mean episodic return`` over fresh episodes of
    the batched env, shared by every point of the z grid."""
    B = batch_size
    env_init, env_step, _ = make_vec_env(cc, B, dtype, device=device)

    @torch.no_grad()
    def run(targets, key):
        policy = make_base_stock_policy(cc, targets, dtype)
        st = env_init(key)
        per_env = torch.zeros((episodes, B), dtype=dtype, device=device)
        for s in range(cc.T * episodes):
            st, out = env_step(st, policy(st.env))
            per_env[s // cc.T] += out.reward
        return per_env.mean()

    return run


def evaluate_state_policy(cc: CompiledChain, batch_size: int, targets,
                          key, episodes: int = 1, dtype=torch.float32,
                          device="cuda") -> float:
    """Mean per-env episodic return of the base-stock policy with the given
    targets (the protocol of ``learn/evaluate.py``'s scan evaluator)."""
    run = _base_stock_runner(cc, batch_size, episodes, dtype,
                             torch.device(device))
    return float(run(targets, key))


def best_base_stock(cc: CompiledChain, batch_size: int, key,
                    zs: Sequence[float] = (0.5, 1.0, 1.5, 2.0, 3.0),
                    episodes: int = 1, dtype=torch.float32, device="cuda"):
    """Grid-search the base-stock multiplier; returns ``(best_z,
    best_return, {z: return})``, every point on the same episodes."""
    run = _base_stock_runner(cc, batch_size, episodes, dtype,
                             torch.device(device))
    scores = {z: float(run(default_base_stock_targets(cc, z), key))
              for z in zs}
    best_z = max(scores, key=scores.get)
    return best_z, scores[best_z], scores


# ---------------------------------------------------------------------------
# The beer game's order-up-to baseline
# ---------------------------------------------------------------------------

def make_beergame_base_stock_policy(levels: int, max_order: int,
                                    v2: bool = True):
    """The scripted order-up-to policy over the true ``BeerGameState``: an
    oracle that sees more than the learned policy's ``inventory - backlog``.

    Per level the inventory position counts what the level owns or is owed:
    ``inventory - backlog + in-transit shipments + orders_placed + the
    upstream level's backlog`` (each level is its upstream's only customer;
    the factory's self-supply pipeline plays the upstream).  The order is
    ``clip(target - IP, 0, max_order - 1)``; v0 (orders = incoming +
    action) first subtracts the pass-through incoming, known from the state,
    v2 orders verbatim.  Returns ``policy(state, targets) -> action [L, B]``
    with ``targets`` a scalar or ``[L]``; integer arithmetic throughout.
    """
    L = levels

    def policy(state, targets):
        inv = state.inventory                          # [L, B]
        B = inv.shape[-1]
        in_transit = state.shipments.sum(dim=0, dtype=inv.dtype)
        owed = torch.cat([state.backlog[1:],
                          torch.zeros((1, B), dtype=inv.dtype,
                                      device=inv.device)], dim=0)
        ip = inv - state.backlog + in_transit + state.orders_placed + owed
        tgt = torch.as_tensor(targets, dtype=inv.dtype,
                              device=inv.device).reshape(-1, 1)
        want = tgt.expand(L, B) - ip
        if not v2:
            # v0 passes the incoming orders through: next week's incoming is
            # the demand row of this week, then the downstream orders
            incoming = torch.cat([state.customer_demand[state.week][None],
                                  state.orders_placed[:-1]], dim=0)
            want = want - incoming
        return torch.clamp(want, 0, max_order - 1).to(inv.dtype)

    return policy


def beergame_base_stock_runner(batch_size: int, levels: int = 4,
                               weeks: int = 35, max_order: int = 16,
                               customer_demand=None, shipment_delays=2,
                               v2: bool = True, max_stock: int = 100,
                               exceeded_capacity_penalty: int = 100,
                               episodes: int = 4, device="cuda"):
    """``run(targets, key) -> (mean, std)`` of the per-env episodic return
    of the order-up-to policy over ``episodes`` fresh episodes (tables
    re-drawn per episode under the Philox keys ``(seed, n + e)``, as
    ``make_beergame_evaluator`` draws them), shared by every point of a
    target grid."""
    from ..core.beergame import make_beergame_kernels

    B, L = batch_size, levels
    tables = beergame_table_config(weeks, customer_demand, shipment_delays,
                                   device)
    weeks, draw = tables["weeks"], tables["draw"]
    reset_k, step_k, _ = make_beergame_kernels(
        L, weeks, tables["max_delay"], v2=v2, max_stock=max_stock,
        exceeded_capacity_penalty=exceeded_capacity_penalty,
        itype=torch.int32, device=device)
    policy = make_beergame_base_stock_policy(L, max_order, v2=v2)
    inv0 = [12] * L

    @torch.no_grad()
    def run(targets, key):
        seed, n = _as_key(key)
        per_env = []
        for e in range(episodes):
            st = reset_k(*draw((seed, n + e), B), inv0, 4, 4, B)
            ret = torch.zeros((B,), dtype=torch.float32, device=device)
            for _ in range(weeks):
                st, (_, r, _) = step_k(st, policy(st, targets))
                ret += r.to(torch.float32)
            per_env.append(ret)
        per_env = torch.stack(per_env)
        return per_env.mean(), per_env.std(correction=0)

    return run


def best_beergame_base_stock(batch_size: int, key,
                             targets: Sequence[int] = tuple(range(4, 41, 2)),
                             device="cuda", **kwargs):
    """Grid-search the order-up-to target (one S for every level), every
    point on the same episodes; returns ``(best_S, (mean, std), {S:
    mean})``.  ``kwargs`` go to ``beergame_base_stock_runner``."""
    run = beergame_base_stock_runner(batch_size, device=device, **kwargs)
    scores, stds = {}, {}
    for s in targets:
        m, sd = run(int(s), key)
        scores[s], stds[s] = float(m), float(sd)
    best_s = max(scores, key=scores.get)
    return best_s, (scores[best_s], stds[best_s]), scores
