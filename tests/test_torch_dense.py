"""Large-topology collection (K5): presets and the plain version against JAX.

* The port's ``nperstage_chain``, ``multiproduct_chain`` and
  ``multiproduct_inccosts_chain`` compile to the JAX presets' chains, field
  by field, at the benchmark's three configurations and at the defaults.
* ``make_supplychain_dense_collect(..., device="cpu")`` (the plain version,
  what the wrapper runs for CPU tensors) reproduces the JAX dense kernel
  ``make_supplychain_dense_collect_pallas(..., mode="actions",
  interpret=True)`` on the shapes of ``tests/test_pallas_dense.py`` and on
  the ``[5, 4, 7, 10]`` x 4 chain over two episodes, at that file's
  tolerances: obs atol 1e-5, rewards atol 1e-5 * max|r|.  XLA:CPU rewrites
  ``x / c`` into a reciprocal product and contracts FMAs, the port does
  neither, and they sum the costs in other orders, so the two differ by a
  few float32 ulps; observed: obs at most 2.4e-7, rewards at most 1.5e-7
  of max|r|.
* The wrapper refuses a bad mode, ``T != cc.T``, a chain beyond the
  kernel's limits and negative capacities, and never runs a CPU tensor
  through the kernel.

The CUDA kernel is compared with the plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 11).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.envs.presets import (  # noqa: E402
    SupplyChainMultiProduct, SupplyChainMultiProduct_IncreasingCosts,
    SupplyChainNPerStage)
from gym_supplychain_tpu.ops.supplychain_pallas_dense import (  # noqa: E402
    make_supplychain_dense_collect_pallas)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402
from gym_supplychain_tpu_torch.ops import supplychain_dense as scd  # noqa: E402

from .test_torch_collect import _struct_fields  # noqa: E402
from .test_torch_compile import _assert_chains_equal  # noqa: E402

_PRESETS = [
    ("sc-Nperstage-multiproduct-v0", SupplyChainNPerStage,
     dict(nodes_per_echelon=[5, 4, 7, 10], num_products=4,
          stochastic_leadtimes=True)),
    ("sc-Nperstage-multiproduct-v0", SupplyChainNPerStage,
     dict(nodes_per_echelon=10, num_products=2, stochastic_leadtimes=True)),
    ("sc-2perstage-multiproduct-v0", SupplyChainMultiProduct,
     dict(num_products=10, stochastic_leadtimes=True)),
    ("sc-Nperstage-multiproduct-v0", SupplyChainNPerStage, {}),
    ("sc-2perstage-multiproduct-v0", SupplyChainMultiProduct, {}),
    ("sc-2perstage-multiproduct-inccosts-v0",
     SupplyChainMultiProduct_IncreasingCosts, {}),
    ("sc-2perstage-multiproduct-inccosts-v0",
     SupplyChainMultiProduct_IncreasingCosts,
     dict(num_products=3, total_time_steps=20)),
]


@pytest.mark.parametrize("env_id,cls,kw", _PRESETS,
                         ids=[f"{e}-{i}" for i, (e, _, _) in
                              enumerate(_PRESETS)])
def test_presets_match_jax(env_id, cls, kw):
    cc = make_chain(env_id, **kw)
    _assert_chains_equal(cc, cls(**kw).cc)
    _assert_chains_equal(cc, jsct.make(env_id, **kw).cc)


def test_benchmark_configs_shapes():
    """The three configurations of the large-topology benchmark, with the
    sizes the kernel is laid out for."""
    got = []
    for kw in ({"nodes_per_echelon": [5, 4, 7, 10], "num_products": 4},
               {"nodes_per_echelon": 10, "num_products": 2}):
        got.append(make_chain("sc-Nperstage-multiproduct-v0",
                              stochastic_leadtimes=True, **kw))
    got.append(make_chain("sc-2perstage-multiproduct-v0", num_products=10,
                          stochastic_leadtimes=True))
    shapes = [(c.N, c.P, c.Dmax, c.A, c.K, c.R, c.obs_dim, c.H + 1)
              for c in got]
    assert shapes == [(26, 4, 10, 492, 138, 10, 353, 3),
                      (40, 2, 10, 620, 320, 10, 261, 3),
                      (8, 10, 2, 140, 32, 2, 261, 3)]
    # (lanes an env, envs a block, stride, shared bytes): 16 lanes; 8 envs
    # of 1425, 1541 and 741 words (odd) a block
    assert [scd.lane_block(c, "dense") for c in got] == [
        (16, 8, 1425, 45600), (16, 8, 1541, 49312), (16, 8, 741, 23712)]
    # one wave at B = 4096: shared memory for 4 or more blocks of 8 envs an
    # SM (228 KB), as the kernel's registers allow
    assert [228 * 1024 // (smem + 1024) * 8 * 132 >= 4096
            for *_, smem in (scd.lane_block(c, "dense") for c in got)] \
        == [True] * 3
    for c in got:
        with pytest.raises(NotImplementedError):
            scc.chain_descriptor(c)              # beyond the collect kernel
        assert scd.dense_descriptor(c).nbytes == scd.DN_DESC_BYTES


def _limit_chain(P, m=scd.DENSE_MAX, R=None):
    """A stand-in with the fields ``dense_edges`` and ``lane_block`` read at
    the size limits ``m``: every node ships on all Dmax slots, R retailers
    (one a node by default)."""
    from types import SimpleNamespace

    N, Dmax, H = m["N"], m["D"], m["RING"] - 1
    Lavg, R = H, R or N
    return SimpleNamespace(
        N=N, P=P, Dmax=Dmax, H=H, R=R, K=m["K"], A=m["A"], Lmax=H,
        obs_dim=R * P + N * P * (1 + Lavg) + 1,
        edge_mask=np.ones((N, Dmax), bool),
        edge_dst=np.arange(N * Dmax).reshape(N, Dmax) % N,
        has_ship=np.ones((N, P), bool), is_retailer=np.zeros(N, bool),
        stock_cap=np.ones(N * P), supply_cap=np.ones(N * P),
        proc_cap=np.ones(N), ship_cap_edge=np.ones((N, Dmax)))


def test_dense_block_at_the_limits():
    """At DENSE_MAX (64 nodes, N*P = 128, Dmax = 16, all 1024 slots used,
    ring 8, R*P = 128) 8 envs still fit in a block of K5: 5,569 words an
    env; past the limits the plan refuses."""
    cc = _limit_chain(P=2)
    words = 128 * (1 + 8) + 128 + 1024 * 3 + 64 + cc.obs_dim
    assert scd.lane_block(cc, "dense") == (16, 8, words | 1,
                                           4 * 8 * (words | 1))
    assert 4 * 8 * (words | 1) == 178208
    with pytest.raises(NotImplementedError, match="shared memory"):
        scd.lane_block(_limit_chain(P=16), "dense")      # N*P = 1024


def _lane_instances():
    """The (G, E, DT, OBS) instances each launch entry builds: ``LN_CASE``
    of ``csrc/supplychain_dense.cu`` (K5), ``csrc/supplychain_lanes.cu``
    (K1) and ``csrc/supplychain_episode.cu`` (K6a)."""
    import re
    from pathlib import Path

    csrc = Path(scd.__file__).parents[1] / "csrc"
    return {kind: {tuple(map(int, c)) for c in re.findall(
        r"LN_CASE\((\d+), (\d+), (\d+), (\d+)\)",
        (csrc / f"supplychain_{src}.cu").read_text())}
        for kind, src in (("dense", "dense"), ("collect", "lanes"),
                          ("episode", "episode"))}


@pytest.mark.parametrize("chain,G,stride", [
    ("supplychain-linear-v0", 4, 41),       # N*P 4, 3 shipping nodes
    ("supplychain-ntom-v0", 8, 109),        # N*P 8, 6 shipping nodes
    ("supplychain-2perstage-v0", 8, 93),    # N*P 8, 6 shipping nodes
    ("collect limits", 16, 1121),           # N*P 32, all 32 nodes ship
])
def test_lane_block_small_chains(chain, G, stride):
    """K1 and K6a plan the least of 4, 8 and 16 lanes that holds max(N*P,
    shipping nodes), 8 envs a block (32-byte obs runs), the episode's
    stretch without the observation; K5 keeps 16 lanes; every plan is an
    instance its launch entry builds, at the chain's slot bound."""
    cc = (_limit_chain(P=1, m=scc._MAX, R=16) if chain == "collect limits"
          else make_chain(chain))        # N = 32, P = 1, Dmax = 8, R = 16
    dt = scd.dense_slot_bound(cc)
    episode = stride - cc.obs_dim | 1
    assert scd.lane_block(cc, "collect") == (G, 8, stride, 32 * stride)
    assert scd.lane_block(cc, "episode") == (G, 8, episode, 32 * episode)
    assert scd.lane_block(cc, "dense")[:3] == (16, 8, stride)
    built = _lane_instances()
    assert (G, 8, dt, 1) in built["collect"]
    assert (G, 8, dt, 0) in built["episode"]
    assert (16, 8, dt, 1) in built["dense"]
    with pytest.raises(ValueError, match="kind"):
        scd.lane_block(cc, "policy")


def test_lane_block_refuses_chains_beyond_the_collect_kernel():
    """K1 and K6a keep the collect kernel's limits (``_MAX``); K5 plans the
    same chain."""
    cc = make_chain("sc-2perstage-multiproduct-v0", num_products=10)
    for kind in ("collect", "episode"):
        with pytest.raises(NotImplementedError, match="collect kernel"):
            scd.lane_block(cc, kind)
    assert scd.lane_block(cc, "dense")[:2] == (16, 8)


@pytest.mark.parametrize("config", ["nperstage-5-4-7-10-x4",
                                    "nperstage-10-x2", "multiproduct-x10",
                                    "supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_dense_edges_sum_like_core_step(config):
    """``dense_edges`` lists each destination's incoming edges in (source
    node, slot) order, and summing a destination's pushes in that order,
    per lead-time, gives ``core/step.py``'s pipeline adds bit for bit (the
    lane-group kernel's order: K5's chains, and K1's and K6a's)."""
    from gym_supplychain_tpu_torch.benchmarks import large_topologies as lt
    from gym_supplychain_tpu_torch.core.step import _in_edge_index

    cc = (make_chain(config) if config.startswith("supplychain")
          else lt.config_chain(config))
    N, D, P = cc.N, cc.Dmax, cc.P
    ed = scd.dense_edges(cc)
    src = [divmod(int(k), D) for k in np.nonzero(ed["edge_id"] >= 0)[0]]
    assert [ed["edge_id"][n * D + d] for n, d in src] == list(range(len(src)))
    assert ed["ship_list"].tolist() == sorted({n for n, _ in src})
    assert len(ed["ship_list"]) == ed["n_ship"]
    for m in range(N):
        es = ed["in_edge"][ed["in_ptr"][m]:ed["in_ptr"][m + 1]].tolist()
        assert es == sorted(es)                          # (node, slot) order
        assert all(cc.edge_dst[src[e]] == m for e in es)
    assert ed["in_ptr"][N] == ed["n_edges"] == len(src)

    rs = np.random.RandomState(len(src))
    push = rs.exponential(3.0, size=(N, D, P)).astype(np.float32)
    push[rs.rand(N, D, P) < 0.3] = 0.0
    ship = np.zeros(N, bool)
    ship[ed["ship_list"]] = True
    push[~ship] = 0.0                                    # nodes that ship none
    lead = rs.randint(1, cc.Lmax + 1, size=(N, D))
    # core/step.py: pushes of every masked edge in np.nonzero order, summed
    # per destination over _in_edge_index's rows (a zero row past a degree)
    e_src, e_di = np.nonzero(cc.edge_mask)
    idx = torch.as_tensor(_in_edge_index(cc))
    for L in range(1, cc.Lmax + 1):
        x = torch.as_tensor(np.where((lead[e_src, e_di] == L)[:, None],
                                     push[e_src, e_di], 0.0))
        xz = torch.cat([x, torch.zeros_like(x[:1])])
        want = xz[idx[0]]
        for k in range(1, idx.shape[0]):
            want = want + xz[idx[k]]
        got = np.zeros((N, P), np.float32)
        for m in range(N):
            for p in range(P):
                s = np.float32(0.0)
                for e in ed["in_edge"][ed["in_ptr"][m]:ed["in_ptr"][m + 1]]:
                    n, d = src[e]
                    if lead[n, d] == L:
                        s = np.float32(s + push[n, d, p])
                got[m, p] = s
        assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))


def _tables(cc, S, B, seed):
    rs = np.random.RandomState(seed)
    act = (2 * rs.rand(S, cc.A, B) - 1).astype(np.float32)
    act[act < -0.5] = -1.0              # some supplies must not fire
    dem = rs.randint(0, 25, size=(S, cc.R, cc.P, B)).astype(np.float32)
    args = [dem]
    if cc.stochastic_leadtimes:
        args.append(rs.randint(1, cc.Lmax + 1, size=(S, cc.K, B))
                    .astype(np.int32))
    return args + [act]


def _chain(name):
    if name == "nperstage [3,2,2,3]x1":
        return SupplyChainNPerStage(nodes_per_echelon=[3, 2, 2, 3],
                                    num_products=1, total_time_steps=10,
                                    stochastic_leadtimes=True).cc
    if name == "nperstage [2,3,2,2]x2":
        return SupplyChainNPerStage(nodes_per_echelon=[2, 3, 2, 2],
                                    num_products=2, total_time_steps=8,
                                    stochastic_leadtimes=True).cc
    if name == "2perstage constant lead-time":
        return jsct.make("supplychain-2perstage-v0", total_time_steps=10,
                         stochastic_leadtimes=False).cc
    if name == "linear":
        return jsct.make("supplychain-linear-v0", total_time_steps=6).cc
    return SupplyChainNPerStage(nodes_per_echelon=[5, 4, 7, 10],
                                num_products=4, total_time_steps=4,
                                stochastic_leadtimes=True).cc


# (chain, B, lane tile of the JAX kernel, episodes, seed)
@pytest.mark.parametrize("name,B,lane_tile,episodes,seed", [
    ("nperstage [3,2,2,3]x1", 4, 4, 1, 0),
    ("nperstage [2,3,2,2]x2", 8, 4, 1, 1),
    ("2perstage constant lead-time", 4, 4, 1, 2),
    ("linear", 4, 4, 2, 3),
    ("nperstage [5,4,7,10]x4", 4, 4, 2, 4),
])
def test_plain_matches_jax_dense_kernel(name, B, lane_tile, episodes, seed):
    cc = _chain(name)
    T, S = cc.T, episodes * cc.T
    args = _tables(cc, S, B, seed)
    jax_run = make_supplychain_dense_collect_pallas(
        cc, T, B, mode="actions", episodes=episodes, lane_tile=lane_tile,
        interpret=True)
    want_obs, want_rew = [np.asarray(x) for x in jax_run(*args)]
    run = scd.make_supplychain_dense_collect(cc, T, B, mode="actions",
                                             episodes=episodes, device="cpu")
    obs, rew = run(*args)
    assert obs.shape == (S, cc.obs_dim, B) and rew.shape == (S, B)
    np.testing.assert_allclose(obs.numpy(), want_obs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rew.numpy(), want_rew, rtol=0,
                               atol=1e-5 * np.abs(want_rew).max())


def test_random_equals_actions_on_philox_tables():
    cc = make_chain("sc-Nperstage-multiproduct-v0",
                    nodes_per_echelon=[2, 3, 2, 2], num_products=2,
                    stochastic_leadtimes=True, total_time_steps=5)
    B, E, seed = 3, 2, 11
    obs, rew = scd.make_supplychain_dense_collect(
        cc, cc.T, B, mode="random", episodes=E, device="cpu")(seed)
    dem, lt, act = scc.philox_tables(cc, seed, range(E * cc.T), B, "cpu")
    obs2, rew2 = scd.make_supplychain_dense_collect(
        cc, cc.T, B, mode="actions", episodes=E, device="cpu")(dem, lt, act)
    assert torch.equal(obs, obs2) and torch.equal(rew, rew2)
    assert bool(torch.isfinite(obs).all()) and bool((obs.abs() <= 1).all())


def test_descriptor_layout_matches_kernel_struct():
    """``DnChain`` of ``csrc/supplychain_lanes.cuh`` is ``ChainT`` at the
    ``DN_MAX_*`` limits, which equal ``DENSE_MAX``; the descriptor's fields
    mirror it (the kernel also checks the byte count at launch)."""
    fields, macros = _struct_fields("supplychain_lanes.cuh", "DnChain")
    assert fields == scd._DN_FIELDS
    assert {k: macros[f"DN_MAX_{k}"] for k in ("N", "P", "NP", "D", "ND",
                                               "NPD", "RING", "RP", "CDF")} \
        == {k: v for k, v in scd.DENSE_MAX.items() if k not in ("K", "A")}
    cc = make_chain("sc-Nperstage-multiproduct-v0",
                    nodes_per_echelon=[5, 4, 7, 10], num_products=4)
    words = scd.dense_descriptor(cc).view(np.int32)
    off = sum(c for name, _, c in fields[:[f[0] for f in fields]
                                         .index("node_deg")])
    # suppliers ship to 4 factories, factories to 7, wholesalers to 10
    assert words[off:off + 64].tolist() == \
        [4] * 5 + [7] * 4 + [10] * 7 + [0] * (64 - 16)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    cc = make_chain("sc-Nperstage-multiproduct-v0", total_time_steps=4)
    with pytest.raises(ValueError, match="mode"):
        scd.make_supplychain_dense_collect(cc, 4, 2, mode="policy",
                                           device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        scd.make_supplychain_dense_collect(cc, 5, 2, device="cpu")
    big = make_chain("sc-Nperstage-multiproduct-v0", nodes_per_echelon=17,
                     num_products=2, total_time_steps=4)      # N = 68
    with pytest.raises(NotImplementedError, match="dense collect kernel"):
        scd.make_supplychain_dense_collect(big, 4, 2, device="cpu")
    bad = dataclasses.replace(cc, ship_cap_edge=-np.asarray(cc.ship_cap_edge))
    with pytest.raises(ValueError, match="negative ship_cap_edge"):
        scd.make_supplychain_dense_collect(bad, 4, 2, device="cpu")
    desc = torch.as_tensor(scd.dense_descriptor(cc))
    with pytest.raises(ValueError, match="CUDA"):
        scd.launch_supplychain_dense(desc, cc, 4, 2, "random", seed=0)
    run = scd.make_supplychain_dense_collect(cc, 4, 2, mode="actions",
                                             device="cpu")
    dem = torch.zeros((4, cc.R, cc.P, 2), device="meta")
    with pytest.raises(ValueError, match="collector on cpu"):
        run(dem, np.zeros((4, cc.A, 2), np.float32))


def test_large_topologies_benchmark_runs_on_the_cpu(capsys):
    """``python -m gym_supplychain_tpu_torch.benchmarks.large_topologies``
    at a tiny size on the CPU: one JSON object with each configuration's
    parity block, eager and dense timings (the plain version throughout)."""
    import json

    from gym_supplychain_tpu_torch.benchmarks import large_topologies as lt

    out = lt.main(["--device", "cpu", "--envs", "2", "--horizon", "3",
                   "--reps", "1", "--eager-steps", "1", "--configs",
                   "multiproduct-x10", "nperstage-5-4-7-10-x4"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert out["device"] == "cpu" and (out["B"], out["T"]) == (2, 3)
    for name in ("multiproduct-x10", "nperstage-5-4-7-10-x4"):
        res = out[name]
        assert res["parity"]["ok"] and res["parity"]["episodes"] == 2
        assert res["dense"]["launches"] == 0         # no kernel on the CPU
        assert res["dense"]["ms_1_episode"] > 0
    assert "nperstage-10-x2" not in out
