"""Supply-chain trajectory collection: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``make_supplychain_collect_pallas`` of
``gym_supplychain_tpu/ops/supplychain_pallas.py`` (``_collect_kernel``) in
its ``random`` and ``actions`` modes.  ``episodes`` back-to-back episodes
run in one launch with auto-reset at every boundary; every step emits its
pre-action observation ``obs [S, O, B]`` and its reward ``reward [S, B]``
(S = episodes * T).

* ``actions`` reads per-step tables: demands ``[S, R, P, B]`` f32,
  lead-times ``[S, K, B]`` int32 (stochastic chains only) and actions
  ``[S, A, B]`` f32 in [-1, 1]; table row s feeds step s.
* ``random`` draws those rows in the kernel from Philox4x32-10 keyed by the
  seed at counter ``(lane, step, block, 0)``: A action uniforms, then K
  lead-time uniforms (stochastic chains), then R*P demand uniforms.  It is
  ``actions`` fed with the tables ``philox_tables`` makes, so the plain
  version of ``random`` is those tables through the plain ``actions``.

The kernel (``csrc/supplychain_collect.cu``) runs one thread per env with
its state in per-thread arrays and the chain in a shared-memory descriptor.
What bounds it on the card, and the float rules it and the plain version
share (no FMA contraction, the pipeline add association, ordered sums, the
stable sorted cut), are set out at the top of that file.  The plain version
is an eager loop over ``core/step.py``; the wrapper takes it only for a
tensor on the CPU, and launches the kernel or raises for a CUDA one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..core.step import make_supplychain_kernels
from ..rng.device import (demand_from_uniform, leadtimes_from_uniform,
                          philox_uniform, poisson_clip_thresholds)

__all__ = ["make_supplychain_collect", "launch_supplychain_collect",
           "supplychain_collect_plain", "philox_tables", "chain_descriptor",
           "seed_key"]

_MODES = {"random": 0, "actions": 1}
_MAX = dict(N=32, P=8, NP=32, D=8, ND=256, NPD=256, RING=8, K=64, A=64,
            RP=16, CDF=8)


def _desc_fields():
    """(name, 'i'|'f', count) in the order of ``struct ScChain``."""
    m = _MAX
    NP, N, ND, NPD = m["NP"], m["N"], m["ND"], m["NPD"]
    ints = ("N", "P", "R", "A", "K", "T", "Lavg", "Lmax", "H", "ring", "dmax",
            "obs_dim", "stochastic", "n_cdf", "any_factory", "pad0")
    fields = [(k, "i", 1) for k in ints]
    fields += [(k, "f", 1) for k in ("c_unmet", "c_stock_pen", "c_proc_pen",
                                     "c_ship_pen")]
    fields += [(k, "f", NP) for k in ("init_stock", "stock_cap", "stock_cost",
                                      "supply_cap", "supply_cost", "proc_cost",
                                      "proc_ratio", "ms", "ms_tail")]
    fields += [(k, "i", NP) for k in ("has_supply", "has_ship", "sup_act_idx",
                                      "ms_ok", "cap_finite")]
    fields += [("proc_cap", "f", N)]
    fields += [(k, "i", N) for k in ("is_factory", "lt_base", "node_ships")]
    fields += [("edge_dst", "i", ND), ("edge_mask", "i", ND),
               ("ship_cap_edge", "f", ND), ("ship_cost", "f", NPD),
               ("ship_act_idx", "i", NPD), ("init_pipe", "f", m["RING"] * NP),
               ("retailer_idx", "i", m["RP"])]
    fields += [(k, "f", m["P"]) for k in ("dem_min", "dem_range", "dem_n",
                                          "dem_lo")]
    fields += [("cdf", "f", m["CDF"])]
    return fields


_DESC_FIELDS = _desc_fields()
DESC_BYTES = 4 * sum(c for _, _, c in _DESC_FIELDS)


def _check_uniform_demand(cc: CompiledChain) -> None:
    for cfg in cc.demand:
        if cfg.std is not None or cfg.sen_peaks is not None:
            raise NotImplementedError(
                "collection draws uniform integer demand only; normal and "
                "seasonal demand are not ported yet")


def _check_kernel_support(cc: CompiledChain) -> None:
    """Raise for a chain the kernel does not take."""
    m = _MAX
    sizes = dict(N=cc.N, P=cc.P, NP=cc.N * cc.P, D=cc.Dmax,
                 ND=cc.N * cc.Dmax, NPD=cc.N * cc.P * cc.Dmax, RING=cc.H + 1,
                 K=cc.K, A=cc.A, RP=cc.R * cc.P, CDF=max(cc.Lmax - 1, 0))
    over = {k: v for k, v in sizes.items() if v > m[k]}
    if over:
        raise NotImplementedError(f"chain too large for the collect kernel: "
                                  f"{over} (limits {m})")
    _check_uniform_demand(cc)
    # the kernel's capacity gates assume capacities >= 0
    for name in ("stock_cap", "supply_cap", "proc_cap", "ship_cap_edge"):
        if (np.asarray(getattr(cc, name)) < 0).any():
            raise ValueError(f"negative {name} in the chain")


def chain_descriptor(cc: CompiledChain) -> np.ndarray:
    """The chain as the bytes of ``struct ScChain`` (uint8 array)."""
    _check_kernel_support(cc)
    N, P, D = cc.N, cc.P, cc.Dmax
    NP = N * P
    has_ship = np.asarray(cc.has_ship) & ~np.asarray(cc.is_retailer)[:, None]
    ms = np.where(cc.max_ship > 0, cc.max_ship, 1.0).astype(np.float32)
    ms_tail = ms * np.float32(cc.Lmax - (cc.Lavg - 1))
    cdf = (poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax)
           if cc.stochastic_leadtimes else np.zeros(0, np.float32))
    cfgs = [cc.demand[p if cc.demand_by_product else 0] for p in range(P)]
    vals = dict(
        N=N, P=P, R=cc.R, A=cc.A, K=cc.K, T=cc.T, Lavg=cc.Lavg, Lmax=cc.Lmax,
        H=cc.H, ring=cc.H + 1, dmax=D, obs_dim=cc.obs_dim,
        stochastic=int(cc.stochastic_leadtimes), n_cdf=len(cdf),
        any_factory=int(np.asarray(cc.is_factory).any()), pad0=0,
        c_unmet=cc.c_unmet, c_stock_pen=cc.c_stock_pen,
        c_proc_pen=cc.c_proc_pen, c_ship_pen=cc.c_ship_pen,
        init_stock=cc.initial_stock, stock_cap=cc.stock_cap,
        stock_cost=cc.stock_cost, supply_cap=cc.supply_cap,
        supply_cost=cc.supply_cost, proc_cost=cc.proc_cost,
        proc_ratio=cc.proc_ratio, ms=ms, ms_tail=ms_tail,
        has_supply=cc.has_supply, has_ship=has_ship,
        sup_act_idx=np.maximum(cc.sup_act_idx, 0),
        ms_ok=np.asarray(cc.max_ship) > 0,
        cap_finite=np.isfinite(cc.stock_cap),
        proc_cap=cc.proc_cap, is_factory=cc.is_factory, lt_base=cc.lt_base,
        node_ships=has_ship.any(axis=1), edge_dst=cc.edge_dst,
        edge_mask=cc.edge_mask, ship_cap_edge=cc.ship_cap_edge,
        ship_cost=cc.ship_cost, ship_act_idx=np.maximum(cc.ship_act_idx, 0),
        init_pipe=cc.init_pipe, retailer_idx=cc.retailer_idx,
        dem_min=cc.dem_min, dem_range=cc.dem_range,
        dem_n=[c.maxv - c.minv + 1 for c in cfgs],
        dem_lo=[c.minv for c in cfgs], cdf=cdf)
    words = np.zeros(DESC_BYTES // 4, np.int32)
    off = 0
    for name, kind, count in _DESC_FIELDS:
        v = np.ravel(np.asarray(vals[name]))
        assert v.size <= count, (name, v.size, count)
        if kind == "f":
            words[off:off + v.size] = v.astype(np.float32).view(np.int32)
        else:
            words[off:off + v.size] = v.astype(np.int32)
        off += count
    return words.view(np.uint8)


def seed_key(seed: int):
    """A seed as the Philox key words ``(low 32 bits, high 32 bits)``."""
    seed = int(seed)
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


def philox_tables(cc: CompiledChain, seed: int, steps, B: int, device):
    """The per-step rows ``random`` mode draws for the global steps
    ``steps``: ``(demands [S,R,P,B] f32, leadtimes [S,K,B] int32 or None,
    actions [S,A,B] f32)``."""
    _check_uniform_demand(cc)
    A, R, P = cc.A, cc.R, cc.P
    Kr = cc.K if cc.stochastic_leadtimes else 0
    u = philox_uniform(seed_key(seed), steps, A + Kr + R * P, B, device)
    actions = 2.0 * u[:, :A] - 1.0
    leadtimes = None
    if cc.stochastic_leadtimes:
        leadtimes = leadtimes_from_uniform(
            u[:, A:A + Kr], poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax))
    ud = u[:, A + Kr:].reshape(u.shape[0], R, P, B)
    demands = torch.stack(
        [demand_from_uniform(ud[:, :, p],
                             cc.demand[p if cc.demand_by_product else 0],
                             0, cc.T, torch.float32) for p in range(P)], dim=2)
    return demands, leadtimes, actions


def supplychain_collect_plain(cc: CompiledChain, episodes: int, B: int,
                              mode: str, seed: int = 0, demands=None,
                              leadtimes=None, actions=None, device=None):
    """Plain version: an eager loop over ``core/step.py`` with auto-reset.

    ``actions`` mode takes S-row tables (``device`` is theirs); ``random``
    draws each episode's tables with ``philox_tables`` on ``device``.
    Returns ``(obs [S,O,B], reward [S,B], final stock [N,P,B])``.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    T = cc.T
    if mode == "actions":
        device = demands.device
    device = torch.device(device)
    reset_fn, step_fn, obs_fn = make_supplychain_kernels(
        cc, dtype=torch.float32, device=device)
    obs = torch.empty((episodes * T, cc.obs_dim, B), dtype=torch.float32,
                      device=device)
    rew = torch.empty((episodes * T, B), dtype=torch.float32, device=device)
    st = None
    for e in range(episodes):
        rows = slice(e * T, (e + 1) * T)
        if mode == "random":
            dem, lt, act = philox_tables(cc, seed, range(e * T, (e + 1) * T),
                                         B, device)
        else:
            dem, act = demands[rows], actions[rows]
            lt = leadtimes[rows] if cc.stochastic_leadtimes else None
        # row T of an episode's demand table only feeds the terminal obs,
        # which auto-reset replaces
        st = reset_fn(torch.cat([dem, dem[-1:]]), lt, B)
        o = obs_fn(st)
        for te in range(T):
            obs[e * T + te] = o
            st, out = step_fn(st, act[te])
            rew[e * T + te] = out.reward
            o = out.obs
    return obs, rew, st.stock


def _check(x, name, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_supplychain_collect(desc: torch.Tensor, cc: CompiledChain, S: int,
                               B: int, mode: str, seed: int = 0,
                               demands=None, leadtimes=None, actions=None):
    """Launch the CUDA collect kernel on the current stream.

    ``desc`` is ``chain_descriptor(cc)`` as a uint8 tensor on the card.
    Returns ``(obs [S,O,B], reward [S,B], final stock [N,P,B])``.
    """
    from ._build import check, library

    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the collect kernel runs on a CUDA device")
    _check(desc, "desc", torch.uint8, (DESC_BYTES,), device)
    null = None
    if mode == "actions":
        _check(demands, "demands", torch.float32, (S, cc.R, cc.P, B), device)
        _check(actions, "actions", torch.float32, (S, cc.A, B), device)
        if cc.stochastic_leadtimes:
            _check(leadtimes, "leadtimes", torch.int32, (S, cc.K, B), device)
        ptrs = (demands.data_ptr(),
                leadtimes.data_ptr() if cc.stochastic_leadtimes else null,
                actions.data_ptr())
    else:
        ptrs = (null, null, null)
    lib = library()
    if lib.sc_chain_bytes() != DESC_BYTES:
        raise RuntimeError("chain descriptor layout differs from the kernel's")
    obs = torch.empty((S, cc.obs_dim, B), dtype=torch.float32, device=device)
    rew = torch.empty((S, B), dtype=torch.float32, device=device)
    stock = torch.empty((cc.N, cc.P, B), dtype=torch.float32, device=device)
    k0, k1 = seed_key(seed)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.sc_collect_launch(
            desc.data_ptr(), DESC_BYTES, _MODES[mode], S, B, *ptrs, k0, k1,
            obs.data_ptr(), rew.data_ptr(), stock.data_ptr(), stream)
    check(code, "supplychain collect")
    launch_supplychain_collect.launches += 1
    return obs, rew, stock


launch_supplychain_collect.launches = 0


def make_supplychain_collect(cc: CompiledChain, T: int, B: int,
                             mode: str = "random", episodes: int = 1,
                             device="cpu"):
    """Trajectory collection over ``episodes`` back-to-back episodes.

    * ``random``: ``run(seed) -> (obs [S,O,B], reward [S,B])``, on
      ``device``;
    * ``actions``: ``run(demands [S,R,P,B], [leadtimes [S,K,B],]
      actions [S,A,B]) -> (obs, reward)``; numpy tables are put on
      ``device``, tensors on another device are rejected.

    A CUDA device launches the kernel; the CPU runs the plain version.
    """
    if T != cc.T:
        raise ValueError(f"T={T} must equal the chain horizon cc.T={cc.T}")
    if mode not in _MODES:
        raise NotImplementedError(
            f"mode {mode!r}: only 'random' and 'actions' are ported")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    S = episodes * T
    # unsupported chains fail here, when the collector is built
    desc = (torch.as_tensor(chain_descriptor(cc), device=device)
            if device.type == "cuda" else None)

    def _run(**kw):
        if desc is not None:
            obs, rew, _ = launch_supplychain_collect(desc, cc, S, B, mode,
                                                     **kw)
        else:
            obs, rew, _ = supplychain_collect_plain(cc, episodes, B, mode,
                                                    device=device, **kw)
        return obs, rew

    if mode == "random":
        def run(seed):
            return _run(seed=seed)
        return run

    def _tensor(x, name, dtype):
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the collector on "
                             f"{device}")
        return x

    def run(demands, *rest):
        if cc.stochastic_leadtimes:
            leadtimes, actions = rest
            leadtimes = _tensor(leadtimes, "leadtimes", torch.int32)
        else:
            (actions,), leadtimes = rest, None
        return _run(demands=_tensor(demands, "demands", torch.float32),
                    leadtimes=leadtimes,
                    actions=_tensor(actions, "actions", torch.float32))

    return run
