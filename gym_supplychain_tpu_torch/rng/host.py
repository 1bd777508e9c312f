"""Host-side (NumPy ``RandomState``) episode-table generation: parity mode.

The port's copy of ``gym_supplychain_tpu/rng/host.py`` (numpy only).  The
reference precomputes whole-episode demand and lead-time tables at every
``reset`` from a single MT19937 stream per env (reference
supplychain_env.py:564, :641-672; demands_generator.py:3-89).  MT19937
``randint``/``normal``/``poisson`` streams cannot be reproduced by the
counter-based Philox streams of ``rng/device.py``, so parity mode generates
the tables on the host with the exact same draw order and the envs put them
on the card once an episode.  The tables are numpy arrays.

The demand processes themselves are vectorized NumPy (the reference's
sinusoidal path is a Python double loop, demands_generator.py:78-84, but the
perturbation draw happens first in one call, so the stream is unaffected).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.compile import CompiledChain, DemandConfig

__all__ = ["generate_demand", "HostEpisodeRNG", "BatchHostRNG"]


def uniform_data(rs: np.random.RandomState, shape, minv, maxv):
    """Uniform integer demand in [minv, maxv] (demands_generator.py:33-36)."""
    return rs.randint(low=minv, high=maxv + 1, size=shape)


def normal_data(rs: np.random.RandomState, shape, minv, maxv, std):
    """Normal demand around the range midpoint (demands_generator.py:38-49)."""
    data = rs.normal((maxv + minv) / 2, std, size=shape)
    np.clip(data, minv, maxv, out=data)
    return np.rint(data).astype(int)


def senoidal_data(rs: np.random.RandomState, horizon, shape, minv, maxv, std,
                  num_peaks, minavg, maxavg, perturb_norm):
    """Seasonal sinusoidal demand with perturbation (demands_generator.py:51-89).

    Stream parity: the perturbation is drawn in a single call of shape
    ``shape`` before any deterministic math, exactly as upstream.
    """
    half_curve = (maxavg - minavg) / 2
    sin_arg = num_peaks * 2 * np.pi / horizon
    if perturb_norm:
        perturb = rs.normal(0, std, size=shape)
    else:
        perturb = rs.randint(low=-3 * std, high=3 * std + 1, size=shape)
    periods = np.arange(shape[0])
    base = minavg + half_curve * (1 + np.sin(sin_arg * periods))
    base = base.reshape((shape[0],) + (1,) * (len(shape) - 1))
    data = np.clip(base + perturb, minv, maxv)
    return np.rint(data).astype(int)


def generate_demand(rs: np.random.RandomState, shape, horizon: int,
                    cfg=None, maxv=None, std=None, sen_peaks=None,
                    minavg=None, maxavg=None, perturb_norm=True):
    """Dispatch mirroring ``generate_demand`` (demands_generator.py:3-31).

    Drop-in for the reference surface — accepts either a ``DemandConfig`` in
    the 4th position or the reference's flat ``(minv, maxv, std, sen_peaks,
    minavg, maxavg, perturb_norm)`` arguments; ``shape`` is the full output
    shape exactly as upstream's ``dem_shape``.
    """
    if not isinstance(cfg, DemandConfig):
        cfg = DemandConfig(minv=cfg, maxv=maxv, std=std, sen_peaks=sen_peaks,
                           minavg=minavg, maxavg=maxavg,
                           perturb_norm=perturb_norm)
    if cfg.sen_peaks is None:
        if cfg.std is None:
            return uniform_data(rs, shape, cfg.minv, cfg.maxv)
        return normal_data(rs, shape, cfg.minv, cfg.maxv, cfg.std)
    std = 0 if cfg.std is None else cfg.std
    return senoidal_data(rs, horizon, shape, cfg.minv, cfg.maxv, std,
                         cfg.sen_peaks, cfg.minavg, cfg.maxavg, cfg.perturb_norm)


class HostEpisodeRNG:
    """One MT19937 stream per env; consecutive episodes continue the stream.

    Draw order per reset mirrors the reference exactly: demand table(s) first
    (one draw of shape (T+1, R, P), or P sequential draws of (T+1, R) in
    by-product mode, supplychain_env.py:641-661), then the Poisson lead-time
    table ``clip(1 + poisson(avg-1), 1, max)`` of shape (T, K) when lead-times
    are stochastic (:664-672).
    """

    def __init__(self, cc: CompiledChain, seed: Optional[int] = None):
        self.cc = cc
        self.seed(seed)

    def seed(self, seed: Optional[int] = None):
        self._rs = np.random.RandomState(seed)

    def episode_tables(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Returns (demands [T+1, R, P] int, leadtimes [T, K] int or None)."""
        cc = self.cc
        if not cc.demand_by_product:
            demands = generate_demand(
                self._rs, (cc.T + 1, cc.R, cc.P), cc.T, cc.demand[0])
        else:
            per_prod = [generate_demand(self._rs, (cc.T + 1, cc.R), cc.T,
                                        cc.demand[p]) for p in range(cc.P)]
            demands = np.stack(per_prod, axis=-1)
        leadtimes = None
        if cc.stochastic_leadtimes:
            leadtimes = 1 + self._rs.poisson(lam=cc.Lavg - 1, size=(cc.T, cc.K))
            leadtimes = np.clip(leadtimes, 1, cc.Lmax)
        return demands, leadtimes

    def batch_tables(self, B: int):
        """Stack B consecutive episodes' tables along a trailing batch axis.

        (Used for batched parity runs; each batch lane consumes the stream in
        sequence, i.e. lane b plays what episode b of a single reference env
        would see.)
        """
        ds, ls = [], []
        for _ in range(B):
            d, l = self.episode_tables()
            ds.append(d)
            ls.append(l)
        demands = np.stack(ds, axis=-1)
        leadtimes = np.stack(ls, axis=-1) if ls[0] is not None else None
        return demands, leadtimes


class BatchHostRNG:
    """B independent MT19937 streams (lane b == a reference env seeded
    ``seeds[b]``), batched table fills.

    Uses the native multithreaded generator (``native``, bit-exact
    NumPy-legacy streams) when the C++ library builds; otherwise a NumPy
    loop over lanes, far slower at thousands of lanes.  ``backend`` says
    which runs: ``"native"`` or ``"numpy"``.
    Per-lane draw order matches ``HostEpisodeRNG`` exactly, and consecutive
    calls continue each lane's stream.
    """

    def __init__(self, cc: CompiledChain, seeds):
        from .. import native

        self.cc = cc
        self.seeds = list(seeds)
        self.B = len(self.seeds)
        self._native = None
        if native.available():
            self._native = native.NativeBatchRNG(self.seeds)
        else:
            self._streams = [np.random.RandomState(s) for s in self.seeds]

    @property
    def backend(self) -> str:
        """``"native"`` (the C++ generator) or ``"numpy"`` (the fallback)."""
        return "numpy" if self._native is None else "native"

    # -- batched draw primitives (each: [B, n] with per-lane streams) ------
    def _randint(self, low, high_excl, n):
        if self._native is not None:
            return self._native.randint(int(low), int(high_excl), n)
        return np.stack([rs.randint(low, high_excl, size=n)
                         for rs in self._streams])

    def _normal(self, loc, scale, n):
        if self._native is not None:
            return self._native.normal(float(loc), float(scale), n)
        return np.stack([rs.normal(loc, scale, size=n)
                         for rs in self._streams])

    def _poisson(self, lam, n):
        if self._native is not None:
            return self._native.poisson(float(lam), n)
        return np.stack([rs.poisson(lam, size=n) for rs in self._streams])

    def _demand(self, cfg: DemandConfig, shape):
        """[B, *shape] demand draws mirroring generate_demand (host.py)."""
        n = int(np.prod(shape))
        if cfg.sen_peaks is None and cfg.std is None:
            return self._randint(cfg.minv, cfg.maxv + 1, n).reshape((self.B,) + shape)
        if cfg.sen_peaks is None:
            data = self._normal((cfg.maxv + cfg.minv) / 2, cfg.std, n)
            data = np.clip(data, cfg.minv, cfg.maxv)
            return np.rint(data).astype(int).reshape((self.B,) + shape)
        std = 0 if cfg.std is None else cfg.std
        if cfg.perturb_norm:
            perturb = self._normal(0, std, n).reshape((self.B,) + shape)
        else:
            perturb = self._randint(-3 * std, 3 * std + 1,
                                    n).reshape((self.B,) + shape)
        periods = np.arange(shape[0]).reshape((1, shape[0])
                                              + (1,) * (len(shape) - 1))
        half = (cfg.maxavg - cfg.minavg) / 2
        base = cfg.minavg + half * (1 + np.sin(
            cfg.sen_peaks * 2 * np.pi * periods / self.cc.T))
        return np.rint(np.clip(base + perturb, cfg.minv, cfg.maxv)).astype(int)

    def episode_tables(self):
        """(demands [T+1, R, P, B], leadtimes [T, K, B] or None)."""
        cc = self.cc
        if not cc.demand_by_product:
            d = self._demand(cc.demand[0], (cc.T + 1, cc.R, cc.P))
        else:
            cols = [self._demand(cc.demand[p], (cc.T + 1, cc.R))
                    for p in range(cc.P)]
            d = np.stack(cols, axis=-1)
        demands = np.moveaxis(d, 0, -1)
        leadtimes = None
        if cc.stochastic_leadtimes:
            lt = 1 + self._poisson(cc.Lavg - 1, cc.T * cc.K)
            lt = np.clip(lt, 1, cc.Lmax).reshape(self.B, cc.T, cc.K)
            leadtimes = np.moveaxis(lt, 0, -1)
        return demands, leadtimes
