"""One episode's demand and lead-time tables in one launch: descriptor and
wrapper of the CUDA draw (``csrc/episode_tables.cu``).

``rng/device.py::device_episode_tables`` launches it for tables on a CUDA
device; ``episode_tables_plain`` there, the eager Philox draw on tensors,
is its plain version and runs everywhere else.  The kernel writes the same
tables bit for bit: a thread an (env, period) draws the period's Philox
words at the counters ``philox_words`` uses and turns them into lead-times
(``leadtimes_from_uniform``) and demands (``demand_from_uniform``).  It
replaces no TPU kernel: the JAX package draws its tables with
``jax.random``.

The descriptor holds what the draw needs of a chain, as int32 words: the
lead-time thresholds, each product's demand process (``demand_constants``)
and each product's seasonal base at every period, computed in double as
``demand_from_uniform`` computes it and rounded to float32, so that the
card takes no ``sin``.  It is copied to a device once per chain.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..rng.device import (demand_constants, poisson_clip_thresholds,
                          seasonal_base)
from ..utils.profiling import count
from .supplychain_collect import _check, resolve_device

__all__ = ["episode_tables_words", "episode_tables_descriptor",
           "launch_episode_tables"]

_PROD_WORDS = 8            # ET_PROD_WORDS of csrc/episode_tables.cu
_CACHE_SIZE = 16           # descriptors kept, the oldest dropped first
_cache = {}


def _f32_words(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _thresholds(cc: CompiledChain) -> np.ndarray:
    if not cc.stochastic_leadtimes:
        return np.zeros((0,), np.float32)
    return poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax)


def _shape(cc: CompiledChain):
    """``(T, R, P, K)``, K the lead-time columns drawn (0: constant)."""
    return cc.T, cc.R, cc.P, cc.K if cc.stochastic_leadtimes else 0


def episode_tables_words(cc: CompiledChain) -> np.ndarray:
    """The draw's descriptor of ``cc`` as int32 words: the thresholds
    ``poisson_clip_thresholds(Lavg - 1, Lmax)`` (none for constant
    lead-times), then ``_PROD_WORDS`` a product (kind, n, lo, std, mid,
    minv, maxv as float32 bits, one unused word), then the seasonal bases
    ``[P][T+1]`` (0 for a product without a season)."""
    prods = np.zeros((cc.P, _PROD_WORDS), np.int32)
    bases = np.zeros((cc.P, cc.T + 1), np.float32)
    for p in range(cc.P):
        cfg = cc.demand[p if cc.demand_by_product else 0]
        c = demand_constants(cfg)
        prods[p, 0] = c["kind"]
        prods[p, 1:7] = _f32_words([c[k] for k in ("n", "lo", "std", "mid",
                                                    "minv", "maxv")])
        if cfg.sen_peaks is not None:
            bases[p] = [seasonal_base(cfg, t, cc.T)
                        for t in range(cc.T + 1)]
    return np.concatenate([_f32_words(_thresholds(cc)), prods.ravel(),
                           _f32_words(bases).ravel()])


def episode_tables_descriptor(cc: CompiledChain, device) -> torch.Tensor:
    """``episode_tables_words(cc)`` on a CUDA ``device``, copied there at
    its first use and kept (the last ``_CACHE_SIZE`` chains and devices)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the episode-table kernel runs on a CUDA device")
    key = (id(cc), device)
    hit = _cache.get(key)
    if hit is not None and hit[0] is cc:
        return hit[1]
    desc = torch.as_tensor(episode_tables_words(cc), device=device)
    while len(_cache) >= _CACHE_SIZE:
        del _cache[next(iter(_cache))]
    _cache[key] = (cc, desc)
    return desc


def launch_episode_tables(cc: CompiledChain, desc: torch.Tensor, ep_key,
                          demands: torch.Tensor, leadtimes=None,
                          lane0: int = 0) -> None:
    """Draw one episode's tables of ``cc`` into ``demands [T+1,R,P,B]``
    (float32 or float64) and ``leadtimes [T,K,B]`` int32 (None for
    constant lead-times) on the current stream: lane ``b`` draws global
    lane ``lane0 + b`` under ``ep_key = (k0, k1)``, as
    ``rng/device.py::episode_tables_plain``.  ``desc`` is
    ``episode_tables_descriptor(cc, device)``; a table on another device,
    or of another shape or dtype, is refused."""
    from ._build import check, library

    device = desc.device
    if not (isinstance(demands, torch.Tensor)
            and demands.dtype in (torch.float32, torch.float64)):
        raise TypeError("demands must be a float32 or float64 tensor")
    T, R, P, K = _shape(cc)
    B = demands.shape[-1] if demands.dim() else 0
    _check(demands, "demands", demands.dtype, (T + 1, R, P, B), device)
    if K:
        _check(leadtimes, "leadtimes", torch.int32, (T, K, B), device)
    elif leadtimes is not None:
        raise ValueError("the chain's lead-times are constant: leadtimes "
                         "must be None")
    if device.type != "cuda":
        raise ValueError("the episode-table kernel runs on a CUDA device")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = library().episode_tables_launch(
            desc.data_ptr(), desc.numel(), T, B, R, P, K,
            int(lane0) & 0xFFFFFFFF, int(ep_key[0]) & 0xFFFFFFFF,
            int(ep_key[1]) & 0xFFFFFFFF, int(demands.dtype == torch.float64),
            demands.data_ptr(), leadtimes.data_ptr() if K else None, stream)
    check(code, "episode-table kernel")
    count("launch.episode_tables")
