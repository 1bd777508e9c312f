"""Strict observation parity: host-side binary-heap mirror.

The port's copy of ``gym_supplychain_tpu/envs/strict_obs.py``.  The push
outputs come in as tensors (on the card or the CPU) and are fetched to the
host once a step.

The reference's ``build_observation`` walks each node's shipment heap in its
*internal array order* (supplychain_env.py:444-461).  heappop reorders that
array, so with stochastic lead-times an in-transit entry can land in the
final >=-bucket even though its arrival time belongs to an earlier bucket
(SURVEY.md §2.1-7).  Dynamics are unaffected (arrivals pop every matching
entry), but bit-exact *observation* parity requires replaying the heap's
array layout.

The dense step engine stays heap-free; in strict mode the single-env wrapper
feeds this mirror with the engine's push introspection outputs
(``StepOutput.sup_push/sup_lt/ship_push/ship_lt``) and rebuilds the
observation exactly as the reference does — including the node-sequential
interleaving of pops and pushes (node i pushes into node j's heap *before*
node j pops its arrivals when i precedes j).
"""
from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np
import torch

from ..core.compile import CompiledChain

__all__ = ["HeapMirror", "to_host"]


def to_host(x) -> np.ndarray:
    """A tensor (or array) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HeapMirror:
    """Mirrors every heap push/pop of one reference env (B=1)."""

    def __init__(self, cc: CompiledChain):
        self.cc = cc
        e_src, e_di = np.nonzero(cc.edge_mask)
        self._e_dst = cc.edge_dst[e_src, e_di]
        # consecutive edge-index block per source node
        self._node_edges = [np.nonzero(e_src == n)[0] for n in range(cc.N)]
        self.reset()

    def reset(self):
        cc = self.cc
        self.heaps: List[List[List[Tuple[int, float]]]] = [
            [[] for _ in range(cc.P)] for _ in range(cc.N)]
        for n, pushes in enumerate(cc.init_push_seq):
            for (p, t, amt) in pushes:
                heapq.heappush(self.heaps[n][p], (t, amt))

    def step(self, t: int, sup_push, sup_lt, ship_push, ship_lt,
             action_dtype=np.float32):
        """Replay one step's pops/pushes in exact reference order
        (SC_Node.act called per node in insertion order,
        supplychain_env.py:714-736).

        Supplied amounts carry the raw action dtype in the reference
        (float32 * int stays float32, SC_Action.apply :49-57), and the obs
        walk then *accumulates* those heap values in float32 — so entries
        are stored with their reference dtype.
        """
        cc = self.cc
        adt = np.dtype(action_dtype).type
        sup_push = to_host(sup_push)[..., 0]           # [N,P]
        sup_lt = to_host(sup_lt)[..., 0]
        ship_push = to_host(ship_push)[..., 0]         # [E,P]
        ship_lt = to_host(ship_lt)[..., 0]             # [E]
        for n in range(cc.N):
            # (a) pop all arrivals of this step (act :220-228)
            for p in range(cc.P):
                h = self.heaps[n][p]
                while h and h[0][0] == t:
                    heapq.heappop(h)
            # (b) supply pushes into own heap, product order (act :244-259)
            for p in range(cc.P):
                if cc.has_supply[n, p] and sup_push[n, p] > 0:
                    heapq.heappush(self.heaps[n][p],
                                   (t + int(sup_lt[n, p]), adt(sup_push[n, p])))
            # (c) ship pushes into destination heaps, product-major then
            #     destination order (act :272-296, :343-348)
            if not cc.is_retailer[n]:
                for p in range(cc.P):
                    if not cc.has_ship[n, p]:
                        continue
                    for e in self._node_edges[n]:
                        if ship_push[e, p] > 0:
                            heapq.heappush(
                                self.heaps[self._e_dst[e]][p],
                                (t + int(ship_lt[e]), ship_push[e, p]))

    def build_observation(self, t: int, stock, demands) -> np.ndarray:
        """Reference _build_observation + SC_Node.build_observation
        (supplychain_env.py:762-791, :428-463) over the mirrored heaps."""
        cc = self.cc
        lo, hi = t + 1, t + cc.Lavg
        obs = []
        dem_row = np.asarray(demands[t], dtype=float)        # [R,P]
        obs.extend(((dem_row - cc.dem_min[None, :])
                    / cc.dem_range[None, :]).reshape(-1))
        for n in range(cc.N):
            for p in range(cc.P):
                obs.append(stock[n, p] / cc.stock_cap[n, p])
            for p in range(cc.P):
                shipments = self.heaps[n][p]
                if not shipments:
                    obs.extend([0.0] * (hi - lo + 1))
                    continue
                # accumulate starting from Python int 0 so dtype promotion
                # follows the reference exactly (f32 entries keep the bucket
                # sum in f32; reference :447-461)
                ms = float(cc.max_ship[n, p])
                ms = int(ms) if ms.is_integer() else ms   # python int upstream
                ship_idx = 0
                for ts in range(lo, hi):
                    val = 0
                    while (ship_idx < len(shipments)
                           and shipments[ship_idx][0] == ts):
                        val = val + shipments[ship_idx][1]
                        ship_idx += 1
                    obs.append(val / ms)
                val = 0
                while ship_idx < len(shipments):
                    val = val + shipments[ship_idx][1]
                    ship_idx += 1
                obs.append(val / (ms * (cc.Lmax - (hi - lo))))
        obs.append((cc.T - t) / cc.T)
        obs = np.asarray(obs, dtype=float)
        return np.clip(2 * obs - 1, -1.0, 1.0)
