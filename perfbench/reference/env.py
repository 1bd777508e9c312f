"""The supply-chain step, written plainly over a batch of lockstep envs.

The batch is the trailing axis: ``stock [N, P, B]``, ``pipe [H, N, P, B]``
(``pipe[j]`` arrives at ``t + 1 + j``).  An episode reads per-step tables:
``demands [T + 1, R, P, B]`` (row t is observed at t and met by the step
from t) and, with stochastic lead-times, ``leadtimes [T, K, B]`` (row t
serves the step from t).  A step runs the reference's six phases:
arrivals, the stock-capacity overflow, supply, shipping (the sorted cut of
the ship actions, the processing and ship capacities), retailer demand and
holding costs; its reward is minus the sum of the eight costs.

``dtype`` is the arithmetic's dtype: float32 as configured, or a lower
precision for a control.
"""
from __future__ import annotations

import numpy as np
import torch

from .chain import Chain

__all__ = ["Env"]


class Env:
    def __init__(self, ch: Chain, device, dtype=torch.float32):
        self.ch, self.device, self.dtype = ch, torch.device(device), dtype
        fl = lambda x: torch.as_tensor(np.asarray(x, np.float64),  # noqa
                                       dtype=dtype, device=self.device)
        ix = lambda x: torch.as_tensor(np.asarray(x, np.int64),  # noqa
                                       device=self.device)
        bo = lambda x: torch.as_tensor(np.asarray(x, bool),  # noqa
                                       device=self.device)
        self.f, self.i, self.b = fl, ix, bo
        ms = np.where(ch.max_ship > 0, ch.max_ship, 1.0).astype(np.float32)
        self.ms = fl(ms)[:, :, None]
        self.ms_tail = fl(ms * np.float32(ch.Lmax - (ch.Lavg - 1)))[:, :,
                                                                    None]
        self.ms_ok = bo(ch.max_ship > 0)[:, :, None]
        self.has_ship = bo(ch.has_ship & ~ch.is_retailer[:, None])
        self.ship_mask = (self.has_ship[:, :, None]
                          & bo(ch.edge_mask)[:, None, :])[..., None]
        e_src, e_di = np.nonzero(ch.edge_mask)
        self.e_src, self.e_di = ix(e_src), ix(e_di)
        e_dst = ch.edge_dst[e_src, e_di]
        # incoming[k, n]: the k-th edge into n, or E (a zero row)
        E = len(e_dst)
        into = [[e for e in range(E) if e_dst[e] == n] for n in range(ch.N)]
        self.incoming = torch.full((max(map(len, into)), ch.N), E,
                                   dtype=torch.int64, device=self.device)
        for n, es in enumerate(into):
            self.incoming[:len(es), n] = ix(es)

    def reset(self, B: int):
        ch = self.ch
        return dict(t=0,
                    stock=self.f(ch.initial_stock)[:, :, None].repeat(1, 1, B),
                    pipe=self.f(ch.init_pipe)[..., None].repeat(1, 1, 1, B))

    def obs(self, st, demands):
        ch, B = self.ch, st["stock"].shape[-1]
        dem = demands[st["t"]]
        dem_obs = ((dem - ch.dem_min) / (ch.dem_max - ch.dem_min)
                   ).reshape(ch.R * ch.P, B)
        pipe = st["pipe"]
        buckets = [torch.where(self.ms_ok, pipe[j] / self.ms, 0.0)
                   for j in range(ch.Lavg - 1)]
        tail = pipe[ch.Lavg - 1:].sum(dim=0)
        buckets.append(torch.where(self.ms_ok, tail / self.ms_tail, 0.0))
        transit = torch.stack(buckets, dim=2).reshape(ch.N, ch.P * ch.Lavg, B)
        stock = st["stock"] / self.f(ch.stock_cap)[:, :, None]
        node = torch.cat([stock, transit], dim=1).reshape(-1, B)
        left = float(np.float32(ch.T - st["t"]) / np.float32(ch.T))
        obs = torch.cat([dem_obs, node,
                         torch.full((1, B), left, dtype=self.dtype,
                                    device=self.device)])
        return torch.clamp(2.0 * obs - 1.0, -1.0, 1.0)

    def _sorted_cut(self, v, stock):
        """Ship actions ``v [N, P, D, B]`` -> amounts: in ascending order of
        the actions (ties by index), the k-th destination asks for the gap
        to the one below it times the stock, and gets what is left."""
        D = v.shape[2]
        d = torch.arange(D, device=self.device)[None, None, :, None]
        below = torch.full_like(v, -torch.inf)
        rank = torch.zeros(v.shape, dtype=torch.int64, device=self.device)
        for j in range(D):
            vj = v[:, :, j:j + 1]
            earlier = (vj < v) | ((vj == v) & (j < d))
            below = torch.maximum(below, torch.where(earlier, vj, -torch.inf))
            rank = rank + earlier
        below = torch.where(rank == 0, 0.0, below)
        want = (v - below) * stock[:, :, None]
        left = stock
        amounts = torch.zeros_like(want)
        for k in range(D):
            sel = rank == k
            got = torch.minimum(torch.where(sel, want, 0.0).sum(dim=2), left)
            left = left - got
            amounts = amounts + torch.where(sel, got[:, :, None], 0.0)
        return amounts

    def _deliver(self, x):
        """Per-edge ``x [..., E, P, B]`` -> per-destination sums."""
        xz = torch.cat([x, torch.zeros_like(x.narrow(-3, 0, 1))], dim=-3)
        out = xz.index_select(-3, self.incoming[0])
        for k in range(1, self.incoming.shape[0]):
            out = out + xz.index_select(-3, self.incoming[k])
        return out

    def step(self, st, action, demands, leadtimes=None):
        """One step from ``st`` under ``action [A, B]`` in [-1, 1] ->
        (next state, reward [B])."""
        ch, f = self.ch, self.f
        N, P, D = ch.N, ch.P, ch.Dmax
        t0 = st["t"]
        B = action.shape[-1]
        a = (action.to(self.dtype) + 1) * 0.5
        has_supply = self.b(ch.has_supply)[:, :, None]
        a_sup = torch.where(has_supply,
                            a[self.i(np.maximum(ch.sup_act_idx, 0))], 0.0)
        a_shp = torch.where(self.ship_mask,
                            a[self.i(np.maximum(ch.ship_act_idx, 0))], 0.0)
        cost = torch.zeros((B,), dtype=self.dtype, device=self.device)

        # 1. arrivals
        stock = st["stock"] + st["pipe"][0]
        pipe = torch.cat([st["pipe"][1:], torch.zeros_like(st["pipe"][:1])])
        # 2. stock-capacity overflow
        cap = f(ch.stock_cap)[:, :, None]
        cost = cost + ch.c_stock_pen * torch.clamp_min(stock - cap, 0.0
                                                       ).sum(dim=(0, 1))
        stock = torch.minimum(stock, cap)
        # 3. supply
        sup = a_sup * f(ch.supply_cap)[:, :, None]
        fired = has_supply & (sup > 0)
        cost = cost + (sup * f(ch.supply_cost)[:, :, None]).sum(dim=(0, 1))
        Ls = torch.arange(1, ch.Lmax + 1, device=self.device)
        lt_base = self.i(ch.lt_base)
        if ch.stochastic:
            row = leadtimes[t0]                                  # [K, B]
            fi = fired.to(torch.int64)
            col = torch.clamp(lt_base[:, None, None] + torch.cumsum(fi, 1)
                              - fi, 0, ch.K - 1)
            lt_sup = torch.gather(row, 0, col.reshape(N * P, B)
                                  ).reshape(N, P, B)
            col = torch.clamp(lt_base[:, None, None] + fi.sum(1)[:, None, :]
                              + torch.arange(D, device=self.device
                                             )[None, :, None], 0, ch.K - 1)
            lt_shp = torch.gather(row, 0, col.reshape(N * D, B)
                                  ).reshape(N, D, B)
            pipe[:ch.Lmax] += torch.where(
                fired[None] & (lt_sup[None] == Ls[:, None, None, None]),
                sup[None], 0.0)
        else:
            pipe[ch.Lavg - 1] += torch.where(fired, sup, 0.0)
        # 4. shipping: the sorted cut, then the processing capacity shared
        # by the products and each edge's ship capacity, product by product
        amounts_all = torch.where(self.b(ch.edge_mask)[:, None, :, None],
                                  self._sorted_cut(a_shp, stock), 0.0)
        fac = self.b(ch.is_factory)
        avail_proc = f(ch.proc_cap)[:, None].expand(N, B)
        avail_ship = f(ch.ship_cap_edge)[:, :, None].expand(N, D, B)
        cols, pushes = [], []
        for p in range(P):
            amounts = amounts_all[:, p]                          # [N, D, B]
            ratio = f(ch.proc_ratio)[:, p, None, None]
            over_proc = torch.zeros((N, B), dtype=self.dtype,
                                    device=self.device)
            if ch.is_factory.any():
                clipped = []
                for k in range(D):
                    x = amounts[:, k]
                    gate = fac[:, None] & (x > 0)
                    over = gate & (x > avail_proc)
                    over_proc = over_proc + torch.where(over, x - avail_proc,
                                                        0.0)
                    x = torch.where(over, avail_proc, x)
                    avail_proc = avail_proc - torch.where(gate, x, 0.0)
                    clipped.append(x)
                amounts = torch.stack(clipped, dim=1)
                to_ship = torch.where(fac[:, None, None], amounts / ratio,
                                      amounts)
            else:
                to_ship = amounts
            gate = (to_ship > 0) & (to_ship > avail_ship)
            over_ship = torch.where(gate, to_ship - avail_ship, 0.0).sum(1)
            shipped = torch.where(gate, avail_ship, to_ship)
            # the shared capacity drops only when it was exceeded, by the
            # amount taken from stock (the reference's own accounting)
            taken = torch.where(gate, torch.where(fac[:, None, None],
                                                  shipped * ratio, shipped),
                                amounts)
            avail_ship = avail_ship - torch.where(gate, taken, 0.0)
            leaving = taken.sum(dim=1)                           # [N, B]
            cols.append(stock[:, p] - leaving)
            cost = cost + torch.where(fac[:, None],
                                      leaving * f(ch.proc_cost)[:, p, None],
                                      0.0).sum(0)
            cost = cost + ch.c_proc_pen * over_proc.sum(0)
            cost = cost + ch.c_ship_pen * over_ship.sum(0)
            cost = cost + (shipped * f(ch.ship_cost)[:, p, :, None]
                           ).sum(dim=(0, 1))
            pushes.append(shipped[self.e_src, self.e_di])        # [E, B]
        stock = torch.stack(cols, dim=1)
        sent = torch.stack(pushes, dim=1)                        # [E, P, B]
        if ch.stochastic:
            lt_e = lt_shp[self.e_src, self.e_di]
            pipe[:ch.Lmax] += self._deliver(torch.where(
                (sent[None] > 0) & (lt_e[None, :, None, :]
                                    == Ls[:, None, None, None]),
                sent[None], 0.0))
        else:
            pipe[ch.Lavg - 1] += self._deliver(torch.where(sent > 0, sent,
                                                           0.0))
        # 5. retailer demand
        ridx = self.i(ch.retailer_idx)
        dem = demands[t0]
        met = torch.minimum(stock[ridx], dem)
        stock[ridx] = stock[ridx] - met
        cost = cost + ch.c_unmet * (dem - met).sum(dim=(0, 1))
        # 6. holding
        cost = cost + (stock * f(ch.stock_cost)[:, :, None]).sum(dim=(0, 1))
        return dict(t=t0 + 1, stock=stock, pipe=pipe), -cost
