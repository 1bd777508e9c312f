"""Beer game: the port's int32 engine and collect plain version against JAX.

Integer arithmetic throughout, so everything is bit-exact: the engine
against ``make_beergame_kernels(itype=int32)``, and the collect kernel's
plain version against ``make_beergame_collect_pallas(..., interpret=True)``
on the cases of ``tests/test_pallas_ops.py`` (v0 over an auto-reset
boundary, v2 with per-lane stochastic delays including zero delays, v2 with
a scalar delay).
"""
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu.core.beergame import (  # noqa: E402
    make_beergame_kernels as jax_kernels)
from gym_supplychain_tpu.ops.beergame_pallas import (  # noqa: E402
    make_beergame_collect_pallas)

from gym_supplychain_tpu_torch.core.beergame import (  # noqa: E402
    make_beergame_kernels)
from gym_supplychain_tpu_torch.core.step import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from gym_supplychain_tpu_torch.ops import beergame_collect as bgc  # noqa: E402

V2 = dict(v2=True, max_stock=25, exceeded_capacity_penalty=37)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("variant", ["v0", "v2"])
def test_engine_matches_jax_bit_exact(variant):
    W, L, B, MAXD = 20, 4, 8, 3
    kw = V2 if variant == "v2" else {}
    rs = np.random.RandomState(4)
    demand = rs.randint(0, 12, size=(W, B)).astype(np.int32)
    delays = np.concatenate([np.full((1, B), 2, np.int32),
                             rs.randint(0, MAXD + 1, size=(W, B))
                             .astype(np.int32)])
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    j_reset, j_step, _ = jax_kernels(L, W, MAXD, itype=jnp.int32, **kw)
    t_reset, t_step, _ = make_beergame_kernels(L, W, MAXD, device="cpu", **kw)
    jst = j_reset(demand, delays, [12] * L, 4, 4, B)
    tst = t_reset(demand, delays, [12] * L, 4, 4, B)
    j_step = jax.jit(j_step)
    for w in range(W):
        jst, (jo, jr, jd) = j_step(jst, actions[w])
        tst, (to, tr, td) = t_step(tst, torch.as_tensor(actions[w]))
        _eq(to, jo, "obs")
        _eq(tr, jr, "reward")
        assert bool(td) == bool(jd)
        for f in ("inventory", "backlog", "orders_placed", "incoming_orders",
                  "shipments", "inventory_costs", "backlog_costs",
                  "penalty_costs"):
            _eq(getattr(tst, f), getattr(jst, f), f)
    assert td


def test_continue_from_jax_mid_episode_state():
    W, L, B = 15, 4, 6
    rs = np.random.RandomState(8)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    delays = np.full(W + 1, 2, np.int32)
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    j_reset, j_step, _ = jax_kernels(L, W, 2, itype=jnp.int32)
    _, t_step, _ = make_beergame_kernels(L, W, 2, device="cpu")
    j_step = jax.jit(j_step)
    jst = j_reset(demand, delays, [12] * L, 4, 4, B)
    for w in range(7):
        jst, _ = j_step(jst, actions[w])
    snap = {k: np.asarray(v) for k, v in jst._asdict().items()}
    tst = state_from_numpy(snap, device="cpu")
    assert tst.week == 7
    for k, v in state_to_numpy(tst).items():
        np.testing.assert_array_equal(v, snap[k], err_msg=k)
    for w in range(7, W):
        jst, (jo, jr, _) = j_step(jst, actions[w])
        tst, (to, tr, _) = t_step(tst, torch.as_tensor(actions[w]))
        _eq(to, jo)
        _eq(tr, jr)


def test_plain_collect_v0_two_episodes_matches_jax_kernel():
    W, L, B, E = 35, 4, 8, 2
    rs = np.random.RandomState(2)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    actions = rs.randint(0, 16, size=(E * W, L, B)).astype(np.int32)
    jo, jr = make_beergame_collect_pallas(W, L, B, episodes=E, mode="actions",
                                          interpret=True)(demand, actions)
    to, tr = bgc.make_beergame_collect(W, L, B, episodes=E,
                                       mode="actions", device="cpu")(
        demand, actions)
    _eq(to, jo)
    _eq(tr, jr)


def test_plain_collect_v2_per_lane_delays_matches_jax_kernel():
    W, L, B, E, MAXD = 20, 4, 8, 2, 3
    rs = np.random.RandomState(5)
    demand = rs.randint(0, 12, size=(E * W, B)).astype(np.int32)
    delays = rs.randint(0, MAXD + 1, size=(E * W, B)).astype(np.int32)
    actions = rs.randint(0, 16, size=(E * W, L, B)).astype(np.int32)
    kw = dict(episodes=E, mode="actions", delay=None, max_delay=MAXD, **V2)
    jo, jr = make_beergame_collect_pallas(W, L, B, interpret=True, **kw)(
        demand, delays, actions)
    to, tr = bgc.make_beergame_collect(W, L, B, device="cpu", **kw)(demand, delays, actions)
    assert (delays == 0).any()
    _eq(to, jo)
    _eq(tr, jr)


def test_plain_collect_v2_scalar_delay_matches_jax_kernel():
    W, L, B = 15, 4, 8
    rs = np.random.RandomState(9)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    kw = dict(episodes=1, mode="actions", v2=True, max_stock=30,
              exceeded_capacity_penalty=11)
    jo, jr = make_beergame_collect_pallas(W, L, B, interpret=True, **kw)(
        demand, actions)
    to, tr = bgc.make_beergame_collect(W, L, B, device="cpu", **kw)(demand, actions)
    _eq(to, jo)
    _eq(tr, jr)


@pytest.mark.parametrize("per_lane", [False, True])
def test_random_equals_actions_on_philox_actions(per_lane):
    W, L, B, E, seed, max_order = 12, 4, 6, 3, 17, 16
    rs = np.random.RandomState(1)
    demand = rs.randint(0, 12, size=(E * W, B)).astype(np.int32)
    kw = dict(delay=None, max_delay=3) if per_lane else {}
    head = ([rs.randint(0, 4, size=(E * W, B)).astype(np.int32)]
            if per_lane else [])
    obs, rew = bgc.make_beergame_collect(W, L, B, episodes=E, mode="random",
                                         max_order=max_order, device="cpu",
                                         **kw)(
        demand, *head, seed)
    act = bgc.philox_actions(seed, range(E * W), L, max_order, B, "cpu")
    assert int(act.min()) >= 0 and int(act.max()) < max_order
    obs2, rew2 = bgc.make_beergame_collect(W, L, B, episodes=E,
                                           mode="actions", device="cpu",
                                           **kw)(
        demand, *head, act)
    assert torch.equal(obs, obs2) and torch.equal(rew, rew2)


def test_wrapper_checks():
    with pytest.raises(ValueError, match="power-of-two"):
        bgc.make_beergame_collect(35, 4, 8, mode="random", max_order=12)
    with pytest.raises(ValueError, match="max_delay"):
        bgc.make_beergame_collect(35, 4, 8, delay=None)
    demand = torch.zeros((35, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bgc.launch_beergame_collect(35, 4, 8, 1, "random", demand=demand)
    # a CPU collector takes no tensor from another device
    with pytest.raises(ValueError, match="collector on cpu"):
        bgc.make_beergame_collect(35, 4, 8, device="cpu")(demand.to("meta"), 0)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5, 6, 8, 9, 16])
@pytest.mark.parametrize("B", [1, 7, 1024, 1031, 4096, 4103])
def test_beergame_block_covers_every_env_once(levels, B):
    """``beergame_block``: G lanes, the power of two at or above the
    levels and at least 4, E envs a block within the kernel's threads, and
    blocks that hold every env once (the last block ragged where E does
    not divide B)."""
    G, E, blocks = bgc.beergame_block(levels, B)
    assert G >= levels and G & (G - 1) == 0 and G in (4, 8, 16)
    assert G == 4 or G < 2 * levels
    assert G * E <= bgc.BG_MAX_THREADS and E in bgc.BG_ENVS
    assert (blocks - 1) * E < B <= blocks * E
    envs = np.arange(blocks)[:, None] * E + np.arange(E)[None, :]
    live = envs[envs < B]
    np.testing.assert_array_equal(np.sort(live), np.arange(B))
    # the largest E that still gives each SM a block, else the smallest
    fits = [e for e in bgc.BG_ENVS if G * e <= bgc.BG_MAX_THREADS]
    wide = [e for e in fits if -(-B // e) >= bgc.BG_MIN_BLOCKS]
    assert E == (wide[0] if wide else fits[-1])


def test_beergame_block_limits_and_kernel_instances():
    """The planner refuses what the kernel does not take, and the kernel
    source builds an instance for each G the planner gives and every ring
    of 1..16 slots (a pipeline of 4, 8 or 16 slots holding it), with the
    limits the wrappers check."""
    from gym_supplychain_tpu_torch.ops import _build

    with pytest.raises(NotImplementedError, match="levels"):
        bgc.beergame_block(17, 64)
    with pytest.raises(ValueError, match="threads"):
        bgc.beergame_block(16, 64, envs=32)
    assert bgc.beergame_block(4, 4096, envs=64) == (4, 64, 64)
    src = (_build.CSRC / "beergame_collect.cu").read_text()
    cases = {(int(g), int(c)) for g, c in
             re.findall(r"BG_CASE\((\d+), (\d+)\)", src)}
    planned = {bgc.beergame_block(L, 64)[0]
               for L in range(1, bgc.BG_MAX_L + 1)}
    for G in planned:
        for ring in range(1, bgc.BG_MAX_RING + 1):
            assert any(g == G and c >= ring for g, c in cases), (G, ring)
    for name in ("BG_MAX_L", "BG_MAX_RING", "BG_MAX_THREADS"):
        m = re.search(rf"#define {name} (\d+)", src)
        assert m and int(m[1]) == getattr(bgc, name), name
    with pytest.raises(NotImplementedError, match="ring"):
        bgc.launch_beergame_collect(
            35, 4, 8, 1, "random", demand=torch.zeros(35, dtype=torch.int32),
            delay=16)


def _old_table(x, weeks, S, B, episodes):
    """The [S, B] table the collector used to build before each launch."""
    if x.ndim == 1:
        x = x[:, None].expand(x.shape[0], B)
    if x.shape[0] == weeks and weeks != S:
        x = x.repeat(episodes, 1)
    return x.contiguous()


@pytest.mark.parametrize("episodes", [1, 3])
@pytest.mark.parametrize("shape", ["weeks", "weeks, B", "S", "S, B",
                                   "weeks, B expanded", "S, B column slice"])
def test_table_views_expand_to_the_old_tables(shape, episodes):
    """The kernel reads demand and per-lane delay tables in place through
    ``table_view``'s rows and strides; expanded on the CPU, what it reads
    is the ``[S, B]`` table the collector built before."""
    W, B = 5, 6
    S = episodes * W
    rs = np.random.RandomState(episodes)
    rows = W if shape.startswith("weeks") else S
    t = torch.as_tensor(rs.randint(-9, 99, size=(rows, 2 * B))
                        .astype(np.int32))
    x = {"weeks": t[:, 0], "S": t[:, 0], "weeks, B": t[:, :B].contiguous(),
         "S, B": t[:, :B].contiguous(),
         "weeks, B expanded": t[:, 0, None].expand(rows, B),
         "S, B column slice": t[:, 1::2]}[shape]
    view = bgc.table_view(x, "demand", W, S, B, torch.device("cpu"))
    assert view[0] is x and view[1] == rows
    got = bgc.expand_table(view, S, B)
    assert torch.equal(got, _old_table(x, W, S, B, episodes))


def test_table_view_rejects_what_the_kernel_does_not_read():
    cpu = torch.device("cpu")
    ok = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        bgc.table_view(torch.zeros((5, 3), dtype=torch.int32), "demand", 4,
                       8, 3, cpu)
    with pytest.raises(ValueError, match="shape"):
        bgc.table_view(torch.zeros((4, 2), dtype=torch.int32), "delays", 4,
                       8, 3, cpu)
    with pytest.raises(ValueError, match="shape"):
        bgc.table_view(torch.zeros((4, 3, 1), dtype=torch.int32), "demand",
                       4, 8, 3, cpu)
    with pytest.raises(TypeError, match="dtype"):
        bgc.table_view(ok.long(), "demand", 4, 8, 3, cpu)
    with pytest.raises(TypeError, match="tensor"):
        bgc.table_view(ok.numpy(), "demand", 4, 8, 3, cpu)
    with pytest.raises(ValueError, match="meta"):
        bgc.table_view(ok.to("meta"), "demand", 4, 8, 3, cpu)


def test_collector_puts_a_numpy_table_on_its_device_once():
    """A numpy demand table goes to the collector's device once and is
    reused while its values hold; a changed table is taken anew."""
    W, L, B = 6, 4, 5
    run = bgc.make_beergame_collect(W, L, B, episodes=2, mode="random",
                                    device="cpu")
    dem = np.array([4, 4, 8, 8, 8, 8], np.int32)
    made = []
    real = torch.tensor

    def spy(x, *a, **k):
        if isinstance(x, np.ndarray):
            made.append(x.shape)
        return real(x, *a, **k)

    with mock.patch.object(torch, "tensor", spy):
        o1, r1 = run(dem, 3)
        o2, r2 = run(dem, 3)
        assert len(made) == 1
        dem[0] = 9
        o3, _ = run(dem, 3)
        assert len(made) == 2
    assert torch.equal(o1, o2) and torch.equal(r1, r2)
    assert not torch.equal(o1, o3)
    want = bgc.make_beergame_collect(W, L, B, episodes=2, mode="random",
                                     device="cpu")(dem.copy(), 3)
    assert torch.equal(o3, want[0])


def test_ptxas_report_names_the_beergame_instances(tmp_path, monkeypatch):
    """Phase 1 of ``chip_smoke.py`` prints each ``bg_collect_kernel``
    instance by its lanes, pipeline slots and episode flag."""
    from gym_supplychain_tpu_torch.ops import _build

    (tmp_path / "beergame_collect.ptxas.txt").write_text(
        "ptxas info    : Compiling entry function "
        "'_Z17bg_collect_kernelILi4ELi4ELi0EEv6BgArgsPKiS2_PiS3_' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_Z17bg_collect_kernelILi4ELi4ELi0EEv6BgArgsPKiS2_PiS3_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 58 registers\n")
    monkeypatch.setattr(_build, "_lib", object())
    monkeypatch.setattr(_build, "_lib_dir", tmp_path)
    assert _build.ptxas_report("bg_collect_kernel") == [dict(
        function="bg_collect_kernel<4,4,0>", registers=58, spill_stores=0,
        spill_loads=0, stack=0)]


def test_beergame_benchmark_cases_agree_on_the_cpu():
    """``benchmarks/beergame.py``'s cases (K3 beergame-v0, the v2
    stochastic config at two batches, K6b): on the CPU each entry point
    runs the plain version and must equal it on the same inputs."""
    from gym_supplychain_tpu_torch.benchmarks import beergame as bb

    cases = bb._cases(6, 0, torch.device("cpu"))
    assert set(cases) == {"k3_v0", "k3_v2_6", "k3_v2_1024", "k6b"}
    for name, (_, entry, plain) in cases.items():
        assert bb._same(entry(), plain()), name
