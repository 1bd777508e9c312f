"""Supply-chain collect kernel: its plain version against the JAX kernel.

The plain version (``supplychain_collect_plain``, what the wrapper runs for
CPU tensors) must reproduce ``make_supplychain_collect_pallas(...,
mode="actions", interpret=True)`` over two back-to-back episodes, so the
auto-reset is covered, at the tolerances of ``tests/test_pallas_collect.py``
(obs atol 1e-6, rewards atol 1e-5 * max|r|).  ``random`` mode must equal
``actions`` fed with the Philox tables, and Philox4x32-10 must give its
published known answers.  The CUDA kernel itself is compared with the plain
version on the card (``chip_smoke.py`` and ``tests/test_torch_kernels.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.ops.supplychain_pallas import (  # noqa: E402
    make_supplychain_collect_pallas)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402
from gym_supplychain_tpu_torch.rng.device import philox4x32  # noqa: E402


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


# horizons off the ring's multiple keep the interpreted JAX kernel quick
@pytest.mark.filterwarnings("ignore:collect horizon")
@pytest.mark.parametrize("env_id,T", [("supplychain-linear-v0", 4),
                                      ("supplychain-ntom-v0", 4),
                                      ("supplychain-2perstage-v0", 2)])
def test_plain_actions_matches_jax_kernel_two_episodes(env_id, T):
    B, E = 4, 2
    cc = jsct.make(env_id, total_time_steps=T).cc
    args = _tables(cc, E * T, B, seed=T)
    jax_run = make_supplychain_collect_pallas(cc, T, B, mode="actions",
                                              episodes=E, interpret=True)
    want_obs, want_rew = [np.asarray(x) for x in jax_run(*args)]
    run = scc.make_supplychain_collect(cc, T, B, mode="actions", episodes=E,
                                       device="cpu")
    obs, rew = run(*args)
    assert obs.shape == (E * T, cc.obs_dim, B) and rew.shape == (E * T, B)
    np.testing.assert_allclose(obs.numpy(), want_obs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rew.numpy(), want_rew, rtol=0,
                               atol=1e-5 * np.abs(want_rew).max())


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox4x32_10_known_answers(counter, key, want):
    c = [torch.tensor([x], dtype=torch.int64) for x in counter]
    got = tuple(int(w) for w in philox4x32(*c, *key))
    assert got == want


@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_random_equals_actions_on_philox_tables(env_id):
    T, B, E, seed = 9, 5, 2, 2 ** 33 + 7
    cc = make_chain(env_id, total_time_steps=T)
    obs, rew = scc.make_supplychain_collect(cc, T, B, mode="random",
                                            episodes=E, device="cpu")(seed)
    dem, lt, act = scc.philox_tables(cc, seed, range(E * T), B, "cpu")
    args = [dem] + ([lt] if cc.stochastic_leadtimes else []) + [act]
    obs2, rew2 = scc.make_supplychain_collect(cc, T, B, mode="actions",
                                              episodes=E, device="cpu")(*args)
    assert torch.equal(obs, obs2) and torch.equal(rew, rew2)
    assert ((act >= -1) & (act < 1)).all()
    cfg = cc.demand[0]
    assert ((dem >= cfg.minv) & (dem <= cfg.maxv)).all()
    if lt is not None:
        assert ((lt >= 1) & (lt <= cc.Lmax)).all()
    # a step's rows depend on the global step, so episodes differ
    assert not torch.equal(obs[:T], obs[T:])


def _struct_fields(source, alias):
    """(fields, macros) of ``using <alias> = ChainT<...>`` in the CUDA file
    ``source``: ``struct ChainT`` of ``csrc/supplychain_step.cuh`` at that
    file's ``#define`` limits, as (name, 'i'|'f', count)."""
    csrc = Path(scc.__file__).parents[1] / "csrc"
    head = (csrc / "supplychain_step.cuh").read_text()
    src = (csrc / source).read_text()
    macros = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\n", src)}
    params, body = re.search(r"template <([^>]*)>\s*struct ChainT \{(.*?)\n\};",
                             head, re.S).groups()
    names = [p.split()[-1] for p in params.split(",")]
    args = re.search(rf"using {alias} = ChainT<([^>]*)>;", src).group(1)
    env = {n: macros[a.strip()] for n, a in zip(names, args.split(","))}
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line or line.startswith("static constexpr"):
            continue
        ctype, decls = line.split(None, 1)
        for name in decls.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(.+)\])?\s*", name)
            count = eval(m.group(2), {}, env) if m.group(2) else 1
            fields.append((m.group(1), "f" if ctype == "float" else "i",
                           count))
    return fields, macros


def test_descriptor_layout_matches_kernel_struct():
    """``_DESC_FIELDS`` mirrors ``ScChain`` (``struct ChainT`` at the
    ``SC_MAX_*`` limits) of the CUDA source field for field (the kernel
    also checks the byte count at launch)."""
    fields, _ = _struct_fields("supplychain_collect.cu", "ScChain")
    assert fields == scc._DESC_FIELDS
    words = scc.chain_descriptor(make_chain("supplychain-ntom-v0"))
    assert words.nbytes == scc.DESC_BYTES == 4 * sum(c for *_, c in fields)


def test_descriptor_rejects_what_the_kernel_does_not_take():
    seasonal = jsct.make("sc-2perstage-seasonal-v0", total_time_steps=4).cc
    # tables carry any demand: only the modes drawing it in-kernel refuse
    assert scc.chain_descriptor(seasonal).nbytes == scc.DESC_BYTES
    for mode in ("random", "policy"):
        with pytest.raises(NotImplementedError):     # seasonal demand
            scc.make_supplychain_collect(seasonal, 4, 2, mode=mode,
                                         hidden=(4,), device="cpu")
    cc = make_chain("supplychain-linear-v0", total_time_steps=4)
    bad = cc.__class__(**{**cc.__dict__,
                          "supply_cap": -np.asarray(cc.supply_cap)})
    with pytest.raises(ValueError):
        scc.chain_descriptor(bad)


def test_wrapper_never_runs_a_cpu_tensor_through_the_kernel():
    from gym_supplychain_tpu_torch.ops.supplychain_dense import (
        dense_descriptor)

    cc = make_chain("supplychain-linear-v0", total_time_steps=3)
    desc = torch.as_tensor(dense_descriptor(cc))
    with pytest.raises(ValueError, match="CUDA"):
        scc.launch_supplychain_collect(desc, cc, 3, 2, "random", seed=0)
    with pytest.raises(NotImplementedError):
        scc.make_supplychain_collect(cc, 3, 2, mode="greedy")
    with pytest.raises(ValueError, match="hidden"):
        scc.make_supplychain_collect(cc, 3, 2, mode="policy")
    with pytest.raises(ValueError):
        scc.make_supplychain_collect(cc, 4, 2, device="cpu")   # T != cc.T
    # a CPU collector takes no tensor from another device
    run = scc.make_supplychain_collect(cc, 3, 2, mode="actions", device="cpu")
    dem = torch.zeros((3, cc.R, cc.P, 2), device="meta")
    act = torch.zeros((3, cc.A, 2), device="meta")
    with pytest.raises(ValueError, match="collector on cpu"):
        run(dem, act)
