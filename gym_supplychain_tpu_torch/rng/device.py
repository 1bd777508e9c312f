"""Counter-based random streams for the port: Philox4x32-10 on tensors.

The JAX package draws its per-step rows from Threefry
(``gym_supplychain_tpu/rng/device.py``).  The port draws the same row layouts
from Philox4x32-10 (Salmon et al., SC'11), the generator its CUDA kernels run
in-kernel, so a row drawn here on the CPU equals the row a kernel draws on the
card.  Streams therefore differ from the JAX package value for value; the
distributions are the same (``tests/test_torch_vector.py``).

Tensors hold 32-bit words in int64 so the arithmetic never overflows:
``_mulhilo`` splits the 32x32-bit product into 16-bit halves.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.compile import CompiledChain, DemandConfig
from ..utils.profiling import span

__all__ = ["poisson_clip_thresholds", "philox4x32", "philox_uniform",
           "philox_words", "uniform_from_bits", "box_muller",
           "demand_from_uniform", "DEMAND_KINDS", "demand_constants",
           "any_normal_demand", "demand_from_uniforms",
           "leadtimes_from_uniform",
           "stateless_step_rows", "seasonal_base", "device_demand_tables",
           "device_leadtime_tables", "device_episode_tables",
           "episode_tables_plain"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57        # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
_MASK = 0xFFFFFFFF


def poisson_clip_thresholds(lam: float, lmax: int) -> np.ndarray:
    """CDF thresholds for sampling clip(1 + Poisson(lam), 1, Lmax).

    Returns ``cdf[j] = P(X <= j)`` for j = 0..Lmax-2; a uniform u maps to
    lead-time ``1 + sum_j(u >= cdf[j])`` which equals Lmax for the whole
    clipped tail.  (Vendored from the JAX package's ``rng/device.py``.)
    """
    if lmax <= 1:
        return np.zeros((0,), np.float32)
    pmf = np.zeros(lmax - 1, np.float64)
    pmf[0] = np.exp(-lam)
    for k in range(1, lmax - 1):
        pmf[k] = pmf[k - 1] * lam / k
    return np.cumsum(pmf).astype(np.float32)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * x`` for a 32-bit constant and words."""
    x_lo = x & 0xFFFF
    x_hi = x >> 16
    p1 = m * x_lo                         # < 2**48
    p2 = m * x_hi                         # < 2**48
    mid = p1 + ((p2 & 0xFFFF) << 16)      # < 2**49
    return (mid >> 32) + (p2 >> 16), mid & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter words ``c0..c3`` (int64 tensors holding
    32-bit values, broadcastable) under the key ``(k0, k1)``.  Returns the
    four output words as int64 tensors."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0 &= _MASK
    k1 &= _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> float32 uniforms in [0, 1): the top 23 bits
    spliced under the exponent of 1.0, minus 1 (as the CUDA kernels do)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def philox_words(key, steps, n_words: int, B: int, device,
                 lane0: int = 0) -> torch.Tensor:
    """Random words ``[len(steps), n_words, B]`` (int64 holding uint32).

    Word ``i`` of lane ``b`` at step ``s`` is word ``i % 4`` of Philox under
    ``key = (k0, k1)`` at counter ``(lane0 + b, s, i // 4, 0)`` — the layout
    the CUDA collect kernels draw in.  ``steps`` is an int64 tensor or a
    range.  ``lane0`` is the global index of the first lane, so that a
    process holding lanes ``lane0 .. lane0 + B - 1`` of a larger batch
    draws what those lanes draw in one process.
    """
    device = torch.device(device)
    steps = torch.as_tensor(steps, dtype=torch.int64, device=device)
    n_blk = -(-n_words // 4)
    lane = torch.arange(lane0, lane0 + B, dtype=torch.int64,
                        device=device) & _MASK
    blk = torch.arange(n_blk, dtype=torch.int64, device=device)
    c0 = lane.view(1, 1, B)
    c1 = steps.view(-1, 1, 1) & _MASK
    c2 = blk.view(1, n_blk, 1)
    c3 = torch.zeros((), dtype=torch.int64, device=device)
    w = torch.stack(philox4x32(c0, c1, c2, c3, int(key[0]), int(key[1])),
                    dim=2)                               # [S, n_blk, 4, B]
    return w.reshape(steps.numel(), n_blk * 4, B)[:, :n_words]


def philox_uniform(key, steps, n_rows: int, B: int, device,
                   lane0: int = 0) -> torch.Tensor:
    """Float32 uniforms ``[len(steps), n_rows, B]`` (see ``philox_words``)."""
    return uniform_from_bits(philox_words(key, steps, n_rows, B, device,
                                          lane0))


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Two uniforms in [0, 1) -> one standard normal,
    ``sqrt(-2 log1p(-u1)) * cos(2 pi u2)``: the JAX package's ``_box_muller``
    (``ops/supplychain_pallas.py``), in the op order the CUDA collect kernel
    follows (``1 - u1`` lies in (0, 1], so the log is finite)."""
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos((2.0 * math.pi) * u2)


def _ndtri(u: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtri(u.to(torch.float64)).to(u.dtype)


def demand_from_uniform(u: torch.Tensor, cfg: DemandConfig, t, T: int,
                        dtype) -> torch.Tensor:
    """Uniforms -> one period's demand values (inverse-CDF versions of the
    reference's demand generators; the JAX package's
    ``_demand_from_uniform``).  Uniform integer demand is
    ``floor(u * n) + minv`` in the uniforms' float32, as the kernels do."""
    if cfg.sen_peaks is None and cfg.std is None:
        n = cfg.maxv - cfg.minv + 1
        return (torch.floor(u * n) + cfg.minv).to(dtype)
    if cfg.sen_peaks is None:
        d = _ndtri(u) * cfg.std + (cfg.maxv + cfg.minv) / 2
        return torch.round(torch.clamp(d, cfg.minv, cfg.maxv)).to(dtype)
    std = 0.0 if cfg.std is None else cfg.std
    if cfg.perturb_norm:
        perturb = _ndtri(u) * std
    else:
        lo, hi = int(-3 * std), int(3 * std)
        perturb = torch.floor(u * (hi - lo + 1)) + lo
    return torch.round(torch.clamp(seasonal_base(cfg, t, T) + perturb,
                                   cfg.minv, cfg.maxv)).to(dtype)


def seasonal_base(cfg: DemandConfig, t, T: int) -> float:
    """A seasonal process's base at period ``t`` of ``T``, in double:
    ``minavg + half * (1 + sin(sen_peaks * 2 pi * t / T))``, ``half`` being
    ``(maxavg - minavg) / 2``."""
    half = (cfg.maxavg - cfg.minavg) / 2
    return cfg.minavg + half * (1 + math.sin(cfg.sen_peaks * 2 * math.pi
                                             * t / T))


# the kernels' demand processes (DEM_* of csrc/supplychain_step.cuh)
DEMAND_KINDS = {"uniform": 0, "normal": 1, "seasonal_normal": 2,
                "seasonal_uniform": 3}


def demand_constants(cfg: DemandConfig) -> dict:
    """One product's demand process as the kernels draw it: its ``kind``
    (``DEMAND_KINDS``) and its constants, folded once from the Python
    numbers the JAX package's ``_demand_from_u`` folds in double and
    rounded to float32 as they meet float32 there.  ``n``/``lo`` are the
    uniform integer draw ``floor(u * n) + lo``: the demand itself, or a
    seasonal process's uniform perturbation in ``[int(-3 std),
    int(3 std)]``; ``std`` the normal's (0 for a seasonal process without
    one); ``mid`` the normal's mean ``(maxv + minv) / 2``; ``minavg``,
    ``half`` (``(maxavg - minavg) / 2``) and ``peaks`` (``sen_peaks *
    2 pi``) the seasonal base; ``minv``/``maxv`` the clip."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    n, lo = cfg.maxv - cfg.minv + 1, cfg.minv
    std = 0.0 if cfg.std is None else cfg.std
    if cfg.sen_peaks is None:
        kind = "uniform" if cfg.std is None else "normal"
    elif cfg.perturb_norm:
        kind = "seasonal_normal"
    else:
        kind = "seasonal_uniform"
        lo, hi = int(-3 * std), int(3 * std)
        n = hi - lo + 1
    seasonal = cfg.sen_peaks is not None
    return dict(
        kind=DEMAND_KINDS[kind], n=f32(n), lo=f32(lo), std=f32(std),
        mid=f32((cfg.maxv + cfg.minv) / 2), minv=f32(cfg.minv),
        maxv=f32(cfg.maxv), minavg=f32(cfg.minavg if seasonal else 0),
        half=f32((cfg.maxavg - cfg.minavg) / 2 if seasonal else 0),
        peaks=f32(cfg.sen_peaks * 2 * math.pi if seasonal else 0))


def any_normal_demand(cc: CompiledChain) -> bool:
    """Whether a product's demand draws a normal, so the kernels' rows hold
    a second block of R*P uniforms (the Box-Muller partners)."""
    normal = (DEMAND_KINDS["normal"], DEMAND_KINDS["seasonal_normal"])
    return any(demand_constants(cfg)["kind"] in normal for cfg in cc.demand)


def demand_from_uniforms(u: torch.Tensor, u2, cfg: DemandConfig, te,
                         T: int) -> torch.Tensor:
    """Float32 uniforms -> one product's demand (float32 integers), the
    kernel form of the draw: the JAX package's ``_demand_from_u``
    (``ops/supplychain_pallas.py``) op for op, as the CUDA collect kernels
    compute it (``ln_demand`` of ``csrc/supplychain_lanes.cuh``).

    ``u2`` holds the Box-Muller partners of ``u`` (``box_muller``: a
    normal from two uniforms, where ``demand_from_uniform`` inverts one
    uniform's CDF); ``te`` is the step within the episode (a tensor or a
    number broadcastable to ``u``), ``T`` the horizon.  The seasonal base is
    ``minavg + half * (1 + sin((peaks * te) / T))`` in float32, divided by
    a tensor so that no device turns the division into a reciprocal's
    product; then ``base + perturbation`` (or ``normal * std + mid``),
    clipped and rounded half to even."""
    c = demand_constants(cfg)
    kind = c["kind"]
    if kind in (DEMAND_KINDS["uniform"], DEMAND_KINDS["seasonal_uniform"]):
        x = torch.floor(u * c["n"]) + c["lo"]
        if kind == DEMAND_KINDS["uniform"]:
            return x
    else:
        x = box_muller(u, u2) * c["std"]
    if kind == DEMAND_KINDS["normal"]:
        x = x + c["mid"]
    else:
        te = torch.as_tensor(te, dtype=torch.float32, device=u.device)
        arg = (te * c["peaks"]) / torch.full_like(te, float(T))
        x = (c["minavg"] + c["half"] * (1.0 + torch.sin(arg))) + x
    return torch.round(torch.clamp(x, c["minv"], c["maxv"]))


def leadtimes_from_uniform(u: torch.Tensor, cdf: np.ndarray) -> torch.Tensor:
    """Uniforms -> lead-times ``1 + sum_j(u >= cdf[j])`` (int32)."""
    lt = torch.ones(u.shape, dtype=torch.int32, device=u.device)
    for c in cdf:
        lt = lt + (u >= float(c)).to(torch.int32)
    return lt


def stateless_step_rows(ep_key, t: int, cc: CompiledChain, B: int,
                        dtype=torch.float32, device="cuda", lane0: int = 0):
    """All of one step's stochastic inputs from one Philox draw.

    Returns ``(demand_row [R,P,B] for period t, leadtime_row [K,B] int32 or
    None)``.  Rows ``0..K-1`` of the draw are the lead-time uniforms (K = 0
    for constant lead-times), then ``R*P`` demand uniforms, as in the JAX
    package's ``stateless_step_rows``; the counter is ``(lane0 + lane, t,
    block, 0)`` under the episode key ``ep_key = (k0, k1)``.
    """
    K = cc.K if cc.stochastic_leadtimes else 0
    u = philox_uniform(ep_key, [t], K + cc.R * cc.P, B, device, lane0)[0]
    lt_row = None
    if cc.stochastic_leadtimes:
        lt_row = leadtimes_from_uniform(
            u[:K], poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax))
    ud = u[K:].reshape(cc.R, cc.P, B)
    cols = [demand_from_uniform(ud[:, p],
                                cc.demand[p if cc.demand_by_product else 0],
                                t, cc.T, dtype)
            for p in range(cc.P)]
    return torch.stack(cols, dim=1), lt_row


def _demand_rows(u: torch.Tensor, cc: CompiledChain, t0: int, dtype):
    """Demand uniforms ``[S, R*P, B]`` of the periods ``t0 ..`` -> demands
    ``[S, R, P, B]``, each row as ``stateless_step_rows`` turns it."""
    S, _, B = u.shape
    ud = u.reshape(S, cc.R, cc.P, B)
    cols = []
    for p in range(cc.P):
        cfg = cc.demand[p if cc.demand_by_product else 0]
        if cfg.sen_peaks is None:         # the period does not enter
            cols.append(demand_from_uniform(ud[:, :, p], cfg, t0, cc.T, dtype))
        else:
            cols.append(torch.stack([
                demand_from_uniform(ud[s, :, p], cfg, t0 + s, cc.T, dtype)
                for s in range(S)]))
    return torch.stack(cols, dim=2)


def episode_tables_plain(ep_key, cc: CompiledChain, B: int,
                         dtype=torch.float32, device="cuda", lane0: int = 0):
    """Plain version of ``device_episode_tables``: the Philox words of every
    period on tensors, then the lead-time and demand processes."""
    K = cc.K if cc.stochastic_leadtimes else 0
    u = philox_uniform(ep_key, range(cc.T + 1), K + cc.R * cc.P, B, device,
                       lane0)
    demands = _demand_rows(u[:, K:], cc, 0, dtype)
    leadtimes = None
    if cc.stochastic_leadtimes:
        leadtimes = leadtimes_from_uniform(
            u[1:, :K], poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax))
    return demands, leadtimes


def device_episode_tables(ep_key, cc: CompiledChain, B: int,
                          dtype=torch.float32, device="cuda", lane0: int = 0):
    """One episode's tables from one Philox draw per period:
    ``(demands [T+1, R, P, B], leadtimes [T, K, B] int32 or None)``.

    Row ``t`` of ``demands`` is the demand row ``stateless_step_rows(ep_key,
    t)`` draws, and row ``t - 1`` of ``leadtimes`` its lead-time row (step
    ``t`` of an episode ships with the lead-times drawn at period ``t``), so
    the table engine fed these tables and the stateless engine keyed
    ``ep_key`` step through the same inputs.  ``lane0`` as
    ``philox_words``.  On a CUDA device one kernel writes the tables
    (``ops/episode_tables.py``); elsewhere ``episode_tables_plain`` draws
    them, with the same bits.
    """
    with span("rng.episode_tables"):
        device = torch.device(device)
        if device.type != "cuda":
            return episode_tables_plain(ep_key, cc, B, dtype, device, lane0)
        from ..ops.episode_tables import (episode_tables_descriptor,
                                          launch_episode_tables)

        desc = episode_tables_descriptor(cc, device)
        device = desc.device
        demands = torch.empty((cc.T + 1, cc.R, cc.P, B), dtype=dtype,
                              device=device)
        leadtimes = (torch.empty((cc.T, cc.K, B), dtype=torch.int32,
                                 device=device)
                     if cc.stochastic_leadtimes else None)
        launch_episode_tables(cc, desc, ep_key, demands, leadtimes, lane0)
        return demands, leadtimes


def device_demand_tables(ep_key, cc: CompiledChain, B: int,
                         dtype=torch.float32, device="cuda"):
    """Demands ``[T+1, R, P, B]`` of ``device_episode_tables``."""
    return device_episode_tables(ep_key, cc, B, dtype, device)[0]


def device_leadtime_tables(ep_key, cc: CompiledChain, B: int, device="cuda"):
    """Lead-times ``[T, K, B]`` int32 of ``device_episode_tables`` (None for
    constant lead-times)."""
    return device_episode_tables(ep_key, cc, B, device=device)[1]
