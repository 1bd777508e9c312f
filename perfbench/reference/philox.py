"""Philox4x32-10 and the program's counter layout, on int64 tensors.

Word ``i`` of lane ``b`` at step ``s`` is word ``i % 4`` of Philox4x32-10
under the key ``(k0, k1)`` at the counter ``(b, s, i // 4, 0)``.  A 64-bit
seed is the key ``(low 32 bits, high 32 bits)``.  Words become float32
uniforms in [0, 1) from their top 23 bits under the exponent of 1.0, minus
1.  Tensors hold 32-bit words in int64, and the 32x32-bit products are
split into 16-bit halves, so nothing overflows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["seed_key", "philox_uniform", "box_muller", "leadtime_cdf",
           "leadtimes", "uniform_demand"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def seed_key(seed: int):
    seed = int(seed)
    return seed & _MASK, (seed >> 32) & _MASK


def _mulhilo(m: int, x: torch.Tensor):
    lo16, hi16 = x & 0xFFFF, x >> 16
    p1, p2 = m * lo16, m * hi16
    mid = p1 + ((p2 & 0xFFFF) << 16)
    return (mid >> 32) + (p2 >> 16), mid & _MASK


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = k0 & _MASK, k1 & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform(key, steps, n: int, B: int, device) -> torch.Tensor:
    """Float32 uniforms ``[len(steps), n, B]`` at the counters above."""
    steps = torch.as_tensor(list(steps), dtype=torch.int64, device=device)
    n_blk = -(-n // 4)
    lane = torch.arange(B, dtype=torch.int64, device=device).view(1, 1, B)
    blk = torch.arange(n_blk, dtype=torch.int64, device=device)
    words = torch.stack(_philox(lane, (steps & _MASK).view(-1, 1, 1),
                                blk.view(1, n_blk, 1),
                                torch.zeros((), dtype=torch.int64,
                                            device=device),
                                int(key[0]), int(key[1])), dim=2)
    words = words.reshape(len(steps), 4 * n_blk, B)[:, :n]
    bits = ((words >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def box_muller(u1, u2):
    """Two uniforms in [0, 1) -> a standard normal."""
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos((2.0 * math.pi)
                                                           * u2)


def leadtime_cdf(lam: float, lmax: int) -> np.ndarray:
    """``P(X <= j)``, j = 0 .. lmax - 2, of X ~ Poisson(lam), in float32: a
    uniform u is the lead-time ``1 + #{j: u >= cdf[j]}``, clipped at lmax."""
    if lmax <= 1:
        return np.zeros(0, np.float32)
    pmf = [math.exp(-lam)]
    for k in range(1, lmax - 1):
        pmf.append(pmf[-1] * lam / k)
    return np.cumsum(np.asarray(pmf, np.float64)).astype(np.float32)


def leadtimes(u: torch.Tensor, cdf: np.ndarray) -> torch.Tensor:
    lt = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    for c in cdf:
        lt = lt + (u >= float(c)).to(torch.int64)
    return lt


def uniform_demand(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Uniform integer demand in [lo, hi], ``floor(u * n) + lo``, float32."""
    n = np.float32(hi - lo + 1)
    return torch.floor(u * float(n)) + float(np.float32(lo))
