"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device.  The file
imports no jax, so it runs on a machine with the card but without jax:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances: supply chain obs atol 1e-6 and rewards atol 1e-5 * max|r| (the
costs are summed in another order), stock bit-equal (the dynamics follow
the same op sequence with no FMA); beer game bit-exact (integers); the
policy modes' pre, logp and value at the JAX collect tests' tolerances; the
update kernel's gradients within 4x the plain float32 error against float64;
the episode kernel's rewards atol 1e-5 * max|r| with its final stock
bit-equal; the dense collect kernel (K5) as the collect kernel; the
beer-game episode sweep (K6b) bit-exact.  K1's ``random``/``actions``, K6a
and K5 are the lane-group kernel; its in-kernel draws, the normal and
seasonal demand among them, equal the plain version's Philox tables bit
for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.ops import beergame_collect as bgc  # noqa: E402
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402
from gym_supplychain_tpu_torch.ops import supplychain_episode as sce  # noqa: E402
from gym_supplychain_tpu_torch.ops._mlp import MlpLayout  # noqa: E402
from gym_supplychain_tpu_torch.ops.supplychain_dense import (  # noqa: E402
    dense_descriptor)
from gym_supplychain_tpu_torch.utils.profiling import counters  # noqa: E402


def launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far (``launch.<kernel>``)."""
    return counters().get("launch." + kernel, 0)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["actions", "random"])
@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_supplychain_kernel_matches_plain(env_id, mode):
    dev = _device()
    cc = make_chain(env_id, total_time_steps=15)
    B, E = 256, 2
    S = E * cc.T
    desc = torch.as_tensor(dense_descriptor(cc), device=dev)
    kw = dict(seed=5)
    if mode == "actions":
        rs = np.random.RandomState(1)
        act = (2 * rs.rand(S, cc.A, B) - 1).astype(np.float32)
        act[act < -0.5] = -1.0
        kw = dict(
            demands=torch.as_tensor(rs.randint(0, 25, size=(S, cc.R, cc.P, B))
                                    .astype(np.float32), device=dev),
            leadtimes=(torch.as_tensor(rs.randint(1, cc.Lmax + 1,
                                                  size=(S, cc.K, B))
                                       .astype(np.int32), device=dev)
                       if cc.stochastic_leadtimes else None),
            actions=torch.as_tensor(act, device=dev))
    before = launches("supplychain_collect")
    k = scc.launch_supplychain_collect(desc, cc, S, B, mode, **kw)
    assert launches("supplychain_collect") == before + 1
    p = scc.supplychain_collect_plain(cc, E, B, mode, device=dev, **kw)
    assert float((k[0] - p[0]).abs().max()) <= 1e-6
    assert float((k[1] - p[1]).abs().max()) <= 1e-5 * float(p[1].abs().max())
    assert torch.equal(k[2], p[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "v0 random", "v0 actions", "v2 per-lane", "L3 random", "L6 actions",
    "L16 random", "delay 0", "ragged", "v2 stochastic max_delay 3",
    "v2 stochastic max_delay 4", "init_delay above delay",
    "tiled tables"])
def test_beergame_kernel_matches_plain(case):
    """K3 against plain, bit-exact: v0 and v2, idle lanes in a group (3, 6
    levels), 16 levels, delay 0, a ragged last block, the v2 stochastic
    config (per-lane delays up to max_delay, 3 and 4), a ring longer than
    the delay, and ``[weeks]`` / ``[weeks, B]`` tables read in place."""
    dev = _device()
    W, L, B, E = 35, 4, 256, 2
    L = {"L3 random": 3, "L6 actions": 6, "L16 random": 16}.get(case, L)
    B = B + 7 if case == "ragged" else B
    S = E * W
    rs = np.random.RandomState(3)
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    kw = dict(mode="random", seed=9,
              demand=put(rs.randint(0, 12, size=(S, B)).astype(np.int32)))
    if "actions" in case or case in ("v2 per-lane", "delay 0", "ragged"):
        kw.update(mode="actions", seed=0, actions=put(
            rs.randint(0, 20, size=(S, L, B)).astype(np.int32)))
    if case == "v2 per-lane":
        kw.update(delay=None, max_delay=4, v2=True, max_stock=40,
                  exceeded_capacity_penalty=37,
                  delays=put(rs.randint(0, 5, size=(S, B)).astype(np.int32)))
    if case.startswith("v2 stochastic"):
        maxd = int(case[-1])
        kw.update(delay=None, max_delay=maxd, v2=True, max_stock=100,
                  exceeded_capacity_penalty=100, delays=put(
                      rs.randint(0, maxd + 1, size=(S, B)).astype(np.int32)))
    if case in ("delay 0", "ragged"):
        kw.update(delay=0 if case == "delay 0" else 3, init_delay=2)
    if case == "init_delay above delay":
        kw.update(delay=1, init_delay=5)
    k = bgc.launch_beergame_collect(W, L, B, E, **kw)
    p = bgc.beergame_collect_plain(W, L, B, E, **kw)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if case == "tiled tables":
        # [weeks] and [weeks, B] tables tiled over the episodes in place
        dem = put(rs.randint(0, 12, size=(W, B)).astype(np.int32))
        dl = put(rs.randint(0, 4, size=W).astype(np.int32))
        kw = dict(mode="random", seed=4, delay=None, max_delay=3)
        k = bgc.launch_beergame_collect(W, L, B, E, demand=dem, delays=dl,
                                        **kw)
        p = bgc.beergame_collect_plain(
            W, L, B, E, demand=dem.repeat(E, 1),
            delays=dl[:, None].expand(W, B).repeat(E, 1), **kw)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_wrappers_launch_the_kernels_for_cuda_devices():
    _device()
    cc = make_chain("supplychain-linear-v0", total_time_steps=6)
    before = launches("supplychain_collect")
    obs, rew = scc.make_supplychain_collect(cc, 6, 64, mode="random",
                                            episodes=2, device="cuda")(1)
    assert launches("supplychain_collect") == before + 1
    assert obs.is_cuda and obs.shape == (12, cc.obs_dim, 64)
    before = launches("beergame_collect")
    spec = make_chain("beergame-v0")
    obs, rew = bgc.make_beergame_collect(spec.weeks, spec.levels, 64,
                                         device="cuda")(spec.demand, 1)
    assert launches("beergame_collect") == before + 1
    assert rew.is_cuda and rew.shape == (spec.weeks, 64)


@pytest.mark.cuda
def test_collectors_built_for_cuda_take_tables_on_the_current_device():
    """A collector built with device="cuda" takes tables made on cuda:0
    (it compared the bare "cuda" with "cuda:0" and refused them)."""
    _device()
    cc = make_chain("supplychain-linear-v0", total_time_steps=4)
    B = 32
    dem = torch.zeros((4, cc.R, cc.P, B), device="cuda")
    act = torch.zeros((4, cc.A, B), device="cuda")
    obs, rew = scc.make_supplychain_collect(cc, 4, B, mode="actions",
                                            device="cuda")(dem, act)
    assert obs.device == dem.device
    spec = make_chain("beergame-v0")
    acts = torch.zeros((spec.weeks, spec.levels, B), dtype=torch.int32,
                       device="cuda")
    obs, rew = bgc.make_beergame_collect(spec.weeks, spec.levels, B,
                                         mode="actions", device="cuda")(
        spec.demand, acts)
    assert rew.device == acts.device

def _policy_model(cc, hidden, dev, seed=0):
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig

    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, hidden),
                        torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        model.mu.w.mul_(100.0)                # non-degenerate actions
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("sample_major", [False, True])
@pytest.mark.parametrize("mode", ["policy_eps", "policy"])
@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_supplychain_policy_kernel_matches_plain(env_id, mode, sample_major):
    """Obs atol 1e-6 (the dynamics follow the plain op order); pre, logp,
    value and rewards at the JAX collect tests' tolerances."""
    dev = _device()
    cc = make_chain(env_id, total_time_steps=15)
    B, E, hidden, seed = 200, 2, (32, 16), 3
    S = E * cc.T
    model = _policy_model(cc, hidden, dev)
    kw = dict(mode=mode, episodes=E, hidden=hidden, sample_major=sample_major)
    run = scc.make_supplychain_collect(cc, cc.T, B, device="cuda", **kw)
    if mode == "policy":
        args = (model, seed)
    else:
        dem, lt, eps = scc.philox_tables(cc, seed, range(S), B, dev,
                                         policy=True)
        args = (dem,) + ((lt,) if cc.stochastic_leadtimes else ()) + (eps,
                                                                      model)
    before = launches("supplychain_policy")
    k = run(*args)
    assert launches("supplychain_policy") == before + 1
    p = scc.supplychain_collect_plain(
        cc, E, B, mode, seed=seed, params=model, sample_major=sample_major,
        device=dev, **({} if mode == "policy" else dict(
            demands=dem, leadtimes=lt, eps=eps)))
    assert float((k[0] - p[0]).abs().max()) <= 1e-6
    assert float((k[1] - p[1]).abs().max()) <= 1e-4
    assert torch.allclose(k[2], p[2], rtol=1e-4, atol=1e-3)
    assert float((k[3] - p[3]).abs().max()) <= 1e-4
    assert float((k[4] - p[4]).abs().max()) <= 1e-5 * float(p[4].abs().max())


def _close_policy(k, p):
    """Phase 6's gates on (obs, act_pre, logp, value, reward, stock)."""
    assert float((k[0] - p[0]).abs().max()) <= 1e-6
    assert float((k[1] - p[1]).abs().max()) <= 1e-4
    assert torch.allclose(k[2], p[2], rtol=1e-4, atol=1e-3)
    assert float((k[3] - p[3]).abs().max()) <= 1e-4
    assert float((k[4] - p[4]).abs().max()) <= 1e-5 * float(p[4].abs().max())
    assert torch.equal(k[5], p[5])


@pytest.mark.cuda
@pytest.mark.parametrize("B,E", [(8 * 12 + 3, 8), (2048 + 5, 16),
                                 (4096 + 7, 32)])
@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_policy_lane_kernel_ragged_batches_at_each_block(env_id, B, E):
    """K1's policy modes on the policy lane kernel at each E the planner
    picks, with a last block that holds inactive envs: ``policy_eps``
    against plain, ``policy`` against ``policy_eps`` on its Philox tables,
    and K4 against plain at the same B, final stock bit-equal."""
    from gym_supplychain_tpu_torch.ops.supplychain_dense import policy_block

    dev = _device()
    T, episodes, hidden, seed = 6, 2, (32, 16), 4
    cc = make_chain(env_id, total_time_steps=T)
    S = episodes * T
    model = _policy_model(cc, hidden, dev)
    lay = MlpLayout(cc.obs_dim, cc.A, hidden)
    assert policy_block(cc, lay, B, 2)[1] == policy_block(cc, lay, B, 1)[1] \
        == E
    desc = torch.as_tensor(dense_descriptor(cc), device=dev)
    args = (desc, cc, lay, torch.as_tensor(lay.ints, device=dev),
            lay.pack(model.flat()), S, B)
    dem, lt, eps = scc.philox_tables(cc, seed, range(S), B, dev, policy=True)
    k_eps = scc.launch_supplychain_policy(*args, "policy_eps", demands=dem,
                                          leadtimes=lt, eps=eps)
    p_eps = scc.supplychain_collect_plain(cc, episodes, B, "policy_eps",
                                          demands=dem, leadtimes=lt, eps=eps,
                                          params=model)
    _close_policy(k_eps, p_eps)
    _close_policy(scc.launch_supplychain_policy(*args, "policy", seed=seed),
                  k_eps)
    rs = np.random.RandomState(B)
    dem = torch.as_tensor(rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B))
                          .astype(np.float32), device=dev)
    lt = (torch.as_tensor(rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B))
                          .astype(np.int32), device=dev)
          if cc.stochastic_leadtimes else None)
    k = sce.launch_supplychain_greedy(*args[:5], B, dem, lt)
    p = sce.supplychain_episode_plain(cc, B, "policy", dem, lt, params=model)
    assert float((k[0] - p[0]).abs().max()) <= 1e-5 * float(p[0].abs().max())
    assert torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_ppo_update_kernel_matches_plain_and_repeats():
    """Kernel and plain float32 gradients against float64 autograd: the
    kernel's error at most 4x the plain version's plus 1e-7 * max|g|; two
    launches give the same bits."""
    from gym_supplychain_tpu_torch.models.policy import (
        ActorCritic, MLPConfig, actor_critic_forward, tanh_gaussian_logp)
    from gym_supplychain_tpu_torch.ops import ppo_update as pu

    dev = _device()
    O, A, hidden, M = 27, 14, (64, 32), 3000
    g = torch.Generator().manual_seed(0)
    model = ActorCritic(MLPConfig(O, A, hidden), g, device=dev)
    obs = (torch.rand((O, M), generator=g) * 2 - 1).to(dev)
    with torch.no_grad():
        mu, log_std, _ = actor_critic_forward(model, obs)
        pre = mu + log_std.exp() * torch.randn((A, M), generator=g).to(dev)
        # old log-probs of a nearby policy: the ratio clip has both branches
        old = (tanh_gaussian_logp(pre, mu, log_std)
               + 0.3 * torch.randn((M,), generator=g).to(dev))
    adv = torch.randn((M,), generator=g).to(dev)
    ret = torch.randn((M,), generator=g).to(dev)
    data = (obs, pre, old, adv, ret)
    _check_ppo_update_kernel(O, A, hidden, M, model, data)


@pytest.mark.cuda
@pytest.mark.parametrize("O,A,hidden,M", [
    (27, 14, (37,), 1000 + 37),             # one hidden layer, ragged tail
    (13, 5, (33, 17, 9), 64 * 7 + 5),       # three odd widths
    (27, 14, (128, 128), 64 * 40 + 63),     # the trainer's widths
])
def test_ppo_update_kernel_ragged_and_odd_widths(O, A, hidden, M):
    """The update kernel at an M that is no multiple of its 64-sample tile
    and at widths that are no multiple of its 4x4 register tiles: phase
    7's gate against float64 autograd, two launches bit-identical."""
    from gym_supplychain_tpu_torch.models.policy import (
        ActorCritic, MLPConfig, actor_critic_forward, tanh_gaussian_logp)

    dev = _device()
    g = torch.Generator().manual_seed(M)
    model = ActorCritic(MLPConfig(O, A, hidden), g, device=dev)
    with torch.no_grad():
        model.mu.w.mul_(10.0)           # mu beyond +-1: the clip gates matter
    obs = (torch.rand((O, M), generator=g) * 2 - 1).to(dev)
    with torch.no_grad():
        mu, log_std, _ = actor_critic_forward(model, obs)
        pre = mu + log_std.exp() * torch.randn((A, M), generator=g).to(dev)
        old = (tanh_gaussian_logp(pre, mu, log_std)
               + 0.3 * torch.randn((M,), generator=g).to(dev))
    adv = torch.randn((M,), generator=g).to(dev)
    ret = torch.randn((M,), generator=g).to(dev)
    _check_ppo_update_kernel(O, A, hidden, M, model, (obs, pre, old, adv, ret))


def _check_ppo_update_kernel(O, A, hidden, M, model, data):
    from gym_supplychain_tpu_torch.ops import ppo_update as pu

    gf = pu.make_ppo_update_grads(O, A, hidden, M)
    before = launches("ppo_update")
    lk, gk = gf(model, *data)
    lk2, gk2 = gf(model, *data)
    assert launches("ppo_update") == before + 2
    assert torch.equal(lk, lk2) and all(torch.equal(a, b)
                                        for a, b in zip(gk, gk2))
    lp, gp = pu.ppo_update_plain(model, *data)
    l64, g64 = pu.ppo_update_plain(model, *(d.double() for d in data))
    scale = max(float(x.abs().max()) for x in g64)
    err_k = max(float((a.double() - b).abs().max()) for a, b in zip(gk, g64))
    err_p = max(float((a.double() - b).abs().max()) for a, b in zip(gp, g64))
    assert err_k <= 4 * err_p + 1e-7 * scale, (err_k, err_p, scale)
    assert abs(float(lk) - float(l64)) <= 4 * abs(float(lp) - float(l64)) \
        + 1e-7 * abs(float(l64))


@pytest.mark.cuda
@pytest.mark.parametrize("O,A,hidden,M", [
    (27, 14, (37,), 1000 + 37),             # one hidden layer, ragged tail
    (13, 5, (33, 17, 9), 64 * 7 + 5),       # three odd widths
    (27, 14, (128, 128), 64 * 40 + 63),     # the trainer's widths
    (27, 14, (64, 32, 16, 8), 3000),        # four hidden layers
    # ragged: the last 128-sample tile's second warpgroup has no sample
    (27, 14, (128, 128), 128 * 20 + 17),
    # the instances <128,1> (two 64-feature chunks held in registers) and
    # <64,2>, ragged
    (27, 14, (128,), 128 * 13 + 77),
    (27, 14, (64, 64), 128 * 9 + 100),
    # 64 obs rows and 32 head rows: the multi-product chains (O 53, A 28)
    (53, 28, (64, 64), 128 * 11 + 45),
    (53, 28, (128,), 128 * 12 + 64),
    (33, 17, (48,), 128 * 5 + 3),
    # the packed-dH instance <64,3,64,32>, ragged
    (53, 28, (64, 64, 64), 128 * 9 + 5),
    (53, 28, (32, 32, 32), 1000),
    # the mma.sync kernel: the nets no wgmma instance holds
    (53, 28, (64, 128), 64 * 30 + 7),
    (53, 28, (128, 64), 2000),
    (79, 60, (64,), 64 * 20 + 1),
    (79, 60, (32, 32), 1500),
    (27, 14, (256,), 64 * 17 + 33),
])
def test_ppo_update_bf16_kernel_matches_plain_and_repeats(O, A, hidden, M):
    """The bf16 update kernel (tensor-core products) against its plain bf16
    version on the same inputs: loss within 1e-3 relative, every gradient
    tensor within 1e-2 * its max, flat cosine >= 0.9999, its cosine to the
    float32 kernel no more than 1e-4 below the plain bf16 version's; two
    launches give the same bits."""
    from gym_supplychain_tpu_torch.models.policy import (
        ActorCritic, MLPConfig, actor_critic_forward, tanh_gaussian_logp)
    from gym_supplychain_tpu_torch.ops import ppo_update as pu

    dev = _device()
    g = torch.Generator().manual_seed(M)
    model = ActorCritic(MLPConfig(O, A, hidden), g, device=dev)
    with torch.no_grad():
        model.mu.w.mul_(10.0)           # mu beyond +-1: the clip gates matter
    obs = (torch.rand((O, M), generator=g) * 2 - 1).to(dev)
    with torch.no_grad():
        mu, log_std, _ = actor_critic_forward(model, obs)
        pre = mu + log_std.exp() * torch.randn((A, M), generator=g).to(dev)
        old = (tanh_gaussian_logp(pre, mu, log_std)
               + 0.3 * torch.randn((M,), generator=g).to(dev))
    adv = torch.randn((M,), generator=g).to(dev)
    ret = torch.randn((M,), generator=g).to(dev)
    data = (obs, pre, old, adv, ret)
    gf = pu.make_ppo_update_grads(O, A, hidden, M,
                                  compute_dtype=torch.bfloat16)
    launcher = {"wgmma": "ppo_update_bf16", "mma": "ppo_update_bf16_mma"}[
        pu.ppo_update_bf16_plan(MlpLayout(O, A, hidden))["kernel"]]
    before = launches(launcher)
    lk, gk = gf(model, *data)
    lk2, gk2 = gf(model, *data)
    assert launches(launcher) == before + 2
    assert torch.equal(lk, lk2) and all(torch.equal(a, b)
                                        for a, b in zip(gk, gk2))
    lp, gp = pu.ppo_update_plain(model, *data, compute_dtype=torch.bfloat16)
    _, g32 = pu.make_ppo_update_grads(O, A, hidden, M)(model, *data)
    assert abs(float(lk) - float(lp)) <= 1e-3 * abs(float(lp))
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max())

    def flat(gs):
        return torch.cat([x.reshape(-1).double() for x in gs])

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    assert cos(flat(gk), flat(gp)) >= 0.9999
    # as near the float32 gradients as the bf16 computation itself
    assert cos(flat(gk), flat(g32)) >= cos(flat(gp), flat(g32)) - 1e-4


@pytest.mark.cuda
def test_bf16_instances_fit_the_card():
    """Every instance of the bf16 update kernel the wrapper plans for is
    built: its shared memory (the library's figure) fits a block, and
    ptxas gives it at most 255 registers, no spill and no stack."""
    import re

    from gym_supplychain_tpu_torch.ops import _build
    from gym_supplychain_tpu_torch.ops._mlp import SMEM_MAX
    from gym_supplychain_tpu_torch.ops.ppo_update import _BF16_INSTANCES

    _device()
    want = {(H, NL, KP, HA) for (H, KP, HA), layers in _BF16_INSTANCES.items()
            for NL in layers}
    lib = _build.library()
    for inst in want:
        assert 0 < lib.ppo_bf16_smem_bytes(*inst) <= SMEM_MAX, inst
    rows = _build.ptxas_report("ppo_grad_bf16_kernel")
    built = {tuple(int(x) for x in re.findall(
        r"-?\d+", r["function"].partition("<")[2])) for r in rows}
    assert built == want
    for r in rows:
        assert r["registers"] <= 255, r
        assert r["spill_stores"] == r["spill_loads"] == r["stack"] == 0, r


@pytest.mark.cuda
def test_bf16_mma_kernel_does_not_spill():
    """The bf16 mode's mma.sync kernel: at most 255 registers, no spill
    (its stack frame holds the layers' tile pointers)."""
    from gym_supplychain_tpu_torch.ops import _build

    _device()
    rows = _build.ptxas_report("ppo_grad_bf16_mma_kernel")
    assert len(rows) == 1
    assert rows[0]["registers"] <= 255
    assert rows[0]["spill_stores"] == rows[0]["spill_loads"] == 0, rows


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["supplychain-ntom-v0",
                                    "sc-2perstage-seasonal-v0"])
def test_policy_kernel_lane0_slices_equal_the_whole(env_id):
    """K1 ``policy`` on two halves of a batch with ``lane0`` gives, bit for
    bit, what one launch over the whole batch gives (a rank's share of a
    data-parallel run draws its global lanes' streams)."""
    from gym_supplychain_tpu_torch.models.policy import ActorCritic, MLPConfig

    dev = _device()
    cc = make_chain(env_id, total_time_steps=12)
    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, (32, 32)),
                        torch.Generator().manual_seed(1), device=dev)
    B = 2 * 1029
    full = scc.make_supplychain_collect(cc, 12, B, mode="policy", device=dev,
                                        hidden=(32, 32))(model, 77)
    parts = [scc.make_supplychain_collect(
        cc, 12, B // 2, mode="policy", device=dev, hidden=(32, 32),
        lane0=lo)(model, 77) for lo in (0, B // 2)]
    for f, a, b in zip(full, *parts):
        assert torch.equal(f, torch.cat([a, b], dim=-1))


@pytest.mark.cuda
def test_bf16_trainer_launches_the_bf16_update_kernel():
    from gym_supplychain_tpu_torch.learn.ppo import PPOConfig, make_ppo_fused

    _device()
    cc = make_chain("supplychain-ntom-v0", total_time_steps=10)
    init_fn, train_step = make_ppo_fused(
        cc, 64, PPOConfig(hidden=(16, 16), epochs=2, fused_update=True,
                          learner_dtype=torch.bfloat16), device="cuda")
    k2 = launches("ppo_update")
    k2b = launches("ppo_update_bf16")
    state, metrics = train_step(init_fn(0))
    assert launches("ppo_update_bf16") == k2b + 2
    assert launches("ppo_update") == k2
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
def test_fused_trainer_launches_both_kernels():
    from gym_supplychain_tpu_torch.learn.ppo import PPOConfig, make_ppo_fused

    _device()
    cc = make_chain("supplychain-ntom-v0", total_time_steps=10)
    init_fn, train_step = make_ppo_fused(
        cc, 64, PPOConfig(hidden=(16, 16), epochs=2, fused_update=True),
        device="cuda")
    k1 = launches("supplychain_policy")
    k2 = launches("ppo_update")
    state, metrics = train_step(init_fn(0))
    assert launches("supplychain_policy") == k1 + 1
    assert launches("ppo_update") == k2 + 2
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["actions", "seeded", "policy"])
@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_supplychain_episode_kernel_matches_plain(env_id, mode):
    """Rewards atol 1e-5 * max|r| (costs summed in another order), final
    stock bit-equal; the runners built with a bare "cuda" launch the
    kernels and take tables made on the current device."""
    dev = _device()
    T, B, hidden, seed = 40, 300, (32, 16), 7
    cc = make_chain(env_id, total_time_steps=T)
    rs = np.random.RandomState(2)
    dem = torch.as_tensor(rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B))
                          .astype(np.float32), device=dev)
    lt = (torch.as_tensor(rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B))
                          .astype(np.int32), device=dev)
          if cc.stochastic_leadtimes else None)
    tables = [dem] + ([lt] if lt is not None else [])
    act = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    act[act < -0.5] = -1.0
    kw = dict(actions=torch.as_tensor(act, device=dev))
    if mode == "seeded":
        kw = dict(seed=seed)
    elif mode == "policy":
        kw = dict(params=_policy_model(cc, hidden, dev))
    if mode == "policy":
        run = sce.make_supplychain_policy_rollout(cc, T, B, hidden=hidden,
                                                  device="cuda")
        launcher = "supplychain_greedy"
    else:
        run = sce.make_supplychain_episode(cc, T, B, device="cuda")[
            mode == "actions"]
        launcher = "supplychain_episode"
    before = launches(launcher)
    rew = run(*tables, *kw.values())
    assert launches(launcher) == before + 1 and rew.device == dem.device
    if mode == "policy":
        desc = torch.as_tensor(dense_descriptor(cc), device=dev)
        lay = MlpLayout(cc.obs_dim, cc.A, hidden)
        k = sce.launch_supplychain_greedy(
            desc, cc, lay, torch.as_tensor(lay.ints, device=dev),
            lay.pack(kw["params"].flat()), B, dem, lt)
    else:
        desc = torch.as_tensor(dense_descriptor(cc), device=dev)
        k = sce.launch_supplychain_episode(desc, cc, B, mode, dem, lt, **kw)
    p = sce.supplychain_episode_plain(cc, B, mode, dem, lt, **kw)
    assert torch.equal(k[0], rew)
    assert float((k[0] - p[0]).abs().max()) <= 1e-5 * float(p[0].abs().max())
    assert torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_greedy_runner_packs_each_weight_version_once():
    """The greedy runner reuses its packed weights while the parameters
    stay the same tensors at the same version, and packs anew after an
    in-place update or for other tensors: its rewards follow the plain
    version through both."""
    dev = _device()
    T, B, hidden = 8, 64, (16, 16)
    cc = make_chain("supplychain-ntom-v0", total_time_steps=T)
    rs = np.random.RandomState(5)
    dem = torch.as_tensor(rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B))
                          .astype(np.float32), device=dev)
    lt = torch.as_tensor(rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B))
                         .astype(np.int32), device=dev)
    run = sce.make_supplychain_policy_rollout(cc, T, B, hidden=hidden,
                                              device="cuda")
    model = _policy_model(cc, hidden, dev)

    def check():
        p = sce.supplychain_episode_plain(cc, B, "policy", dem, lt,
                                          params=model)[0]
        k = run(dem, lt, model)
        assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())
        return k

    first = check()
    assert torch.equal(run(dem, lt, model), first)
    with torch.no_grad():
        model.mu.w.mul_(-1.0)
    assert not torch.equal(check(), first)
    model = _policy_model(cc, hidden, dev, seed=1)
    check()


def _small_chain(name, T):
    if name == "nperstage [2,3,2,2]x2":    # N*P 18: 16 lanes; Dmax 3 of 2-3
        return make_chain("sc-Nperstage-multiproduct-v0",
                          nodes_per_echelon=[2, 3, 2, 2], num_products=2,
                          stochastic_leadtimes=True, total_time_steps=T)
    return make_chain(name, total_time_steps=T)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,mode", [("collect", "actions"),
                                         ("collect", "random"),
                                         ("episode", "actions"),
                                         ("episode", "seeded")])
@pytest.mark.parametrize("chain", ["supplychain-ntom-v0",
                                   "nperstage [2,3,2,2]x2"])
def test_lane_kernels_negative_values_and_ragged_batch(chain, kernel, mode):
    """K1 (``collect``) and K6a (``episode``) on the lane-group kernel at a
    B that is no multiple of its 8 envs a block; in ``actions`` some
    actions below -1 give negative supplies and ship values, so the degree
    elision falls back to all Dmax slots there.  Obs atol 1e-6, rewards
    atol 1e-5 * max|r|, final stock bit-equal."""
    dev = _device()
    T, E, B, seed = 10, 2, 8 * 12 + 3, 6
    cc = _small_chain(chain, T)
    S = E * T if kernel == "collect" else T
    rs = np.random.RandomState(B)
    act = (3 * rs.rand(S, cc.A, B) - 2).astype(np.float32)      # [-2, 1)
    assert (act < -1).mean() > 0.2
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    dem = put(rs.randint(0, 25, size=(S + (kernel == "episode"), cc.R, cc.P,
                                      B)).astype(np.float32))
    lt = put(rs.randint(1, cc.Lmax + 1, size=(S, cc.K, B)).astype(np.int32))
    kw = (dict(seed=seed) if mode in ("random", "seeded")
          else dict(actions=put(act)))
    desc = torch.as_tensor(dense_descriptor(cc), device=dev)
    if kernel == "collect":
        if mode == "actions":
            kw.update(demands=dem, leadtimes=lt)
        k = scc.launch_supplychain_collect(desc, cc, S, B, mode, **kw)
        p = scc.supplychain_collect_plain(cc, E, B, mode, device=dev, **kw)
        assert float((k[0] - p[0]).abs().max()) <= 1e-6
        k, p = k[1:], p[1:]
    else:
        k = sce.launch_supplychain_episode(desc, cc, B, mode, dem, lt, **kw)
        p = sce.supplychain_episode_plain(cc, B, mode, dem, lt, **kw)
    assert float((k[0] - p[0]).abs().max()) <= 1e-5 * float(p[0].abs().max())
    assert torch.equal(k[1], p[1])
    assert bool(torch.isfinite(k[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["collect", "episode"])
@pytest.mark.parametrize("chain", ["supplychain-linear-v0",
                                   "supplychain-ntom-v0",
                                   "nperstage [2,3,2,2]x2"])
def test_lane_kernel_draws_equal_their_tables(chain, kernel):
    """K1 ``random`` equals K1 ``actions`` fed ``philox_tables``, and K6a
    ``seeded`` equals K6a ``actions`` fed ``seeded_actions``, bit for bit:
    the kernel draws the Philox words the plain version does."""
    dev = _device()
    T, E, B, seed = 12, 2, 8 * 9 + 5, 2 ** 33 + 1
    cc = _small_chain(chain, T)
    desc = torch.as_tensor(dense_descriptor(cc), device=dev)
    if kernel == "collect":
        S = E * T
        k = scc.launch_supplychain_collect(desc, cc, S, B, "random", seed=seed)
        dem, lt, act = scc.philox_tables(cc, seed, range(S), B, dev)
        t = scc.launch_supplychain_collect(desc, cc, S, B, "actions",
                                           demands=dem, leadtimes=lt,
                                           actions=act)
    else:
        rs = np.random.RandomState(3)
        dem = torch.as_tensor(rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B))
                              .astype(np.float32), device=dev)
        lt = (torch.as_tensor(rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B))
                              .astype(np.int32), device=dev)
              if cc.stochastic_leadtimes else None)
        k = sce.launch_supplychain_episode(desc, cc, B, "seeded", dem, lt,
                                           seed=seed)
        t = sce.launch_supplychain_episode(
            desc, cc, B, "actions", dem, lt,
            actions=sce.seeded_actions(cc, seed, B, dev))
    assert all(torch.equal(a, b) for a, b in zip(k, t))


_DEMAND_CHAINS = {
    "seasonal": ("sc-2perstage-seasonal-v0", {}),
    "seasonal uniform perturbation": ("sc-2perstage-seasonal-v0",
                                      dict(demand_perturb_norm=False)),
    "multiproduct-v1": ("sc-2perstage-multiproduct-v1", {}),
    "multiproduct-v1 normal": ("sc-2perstage-multiproduct-v1",
                               dict(num_products=3, demand_std=10,
                                    demand_perturb_norm=True)),
    "nperstage seasonal": ("sc-Nperstage-multiproduct-v0", dict(
        nodes_per_echelon=[2, 3, 2, 2], num_products=2,
        stochastic_leadtimes=True, demand_std=10, demand_sen_peaks=4,
        avg_demand_range=(150, 250), demand_perturb_norm=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["collect", "policy", "dense"])
@pytest.mark.parametrize("chain", sorted(_DEMAND_CHAINS))
def test_demand_processes_drawn_in_kernel(chain, kernel):
    """Normal and seasonal demand drawn in the kernel: K1 ``random`` (and
    K5 ``random``) equal to ``actions`` fed ``philox_tables`` bit for bit,
    K1 ``policy`` to ``policy_eps`` on its tables, and each against its
    plain version (obs and stock bit-equal: the draw follows the plain
    version's float32 ops; rewards atol 1e-5 * max|r|, the cost sum's
    order) at a ragged B, two episodes crossing the auto-reset."""
    from gym_supplychain_tpu_torch.ops import supplychain_dense as scd

    dev = _device()
    env_id, kw = _DEMAND_CHAINS[chain]
    T, E, B, seed, hidden = 14, 2, 8 * 11 + 5, 2 ** 35 + 9, (16,)
    cc = make_chain(env_id, total_time_steps=T, **kw)
    S = E * T
    desc = torch.as_tensor(dense_descriptor(cc), device=dev)
    if kernel == "policy":
        model = _policy_model(cc, hidden, dev)
        lay = MlpLayout(cc.obs_dim, cc.A, hidden)
        args = (desc, cc, lay, torch.as_tensor(lay.ints, device=dev),
                lay.pack(model.flat()), S, B)
        k = scc.launch_supplychain_policy(*args, "policy", seed=seed)
        dem, lt, eps = scc.philox_tables(cc, seed, range(S), B, dev,
                                         policy=True)
        t = scc.launch_supplychain_policy(*args, "policy_eps", demands=dem,
                                          leadtimes=lt, eps=eps)
        p = scc.supplychain_collect_plain(cc, E, B, "policy", seed=seed,
                                          params=model, device=dev)
        assert all(torch.equal(a, b) for a, b in zip(k, t))
        _close_policy(k, p)
        assert torch.equal(k[0], p[0])
        return
    launch = (scd.launch_supplychain_dense if kernel == "dense"
              else scc.launch_supplychain_collect)
    k = launch(desc, cc, S, B, "random", seed=seed)
    dem, lt, act = scc.philox_tables(cc, seed, range(S), B, dev)
    t = launch(desc, cc, S, B, "actions", demands=dem, leadtimes=lt,
               actions=act)
    p = scc.supplychain_collect_plain(cc, E, B, "random", seed=seed,
                                      device=dev)
    assert all(torch.equal(a, b) for a, b in zip(k, t))
    assert torch.equal(k[0], p[0]) and torch.equal(k[2], p[2])
    assert float((k[1] - p[1]).abs().max()) <= 1e-5 * float(p[1].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["actions", "random"])
@pytest.mark.parametrize("chain", ["nperstage [5,4,7,10]x4",
                                   "nperstage [2,3,2,2]x2 constant",
                                   "multiproduct x10", "linear"])
def test_supplychain_dense_kernel_matches_plain(chain, mode):
    """K5: obs atol 1e-6, rewards atol 1e-5 * max|r| (costs summed in
    another order), final stock bit-equal, over 2 episodes; the collector
    built with a bare "cuda" launches the kernel once a call."""
    from gym_supplychain_tpu_torch.ops import supplychain_dense as scd

    dev = _device()
    T, B, E = 12, 96, 2
    if chain == "nperstage [5,4,7,10]x4":
        cc = make_chain("sc-Nperstage-multiproduct-v0",
                        nodes_per_echelon=[5, 4, 7, 10], num_products=4,
                        stochastic_leadtimes=True, total_time_steps=T)
    elif chain == "nperstage [2,3,2,2]x2 constant":
        cc = make_chain("sc-Nperstage-multiproduct-v0",
                        nodes_per_echelon=[2, 3, 2, 2], num_products=2,
                        total_time_steps=T)
    elif chain == "multiproduct x10":
        cc = make_chain("sc-2perstage-multiproduct-v0", num_products=10,
                        stochastic_leadtimes=True, total_time_steps=T)
    else:
        cc = make_chain("supplychain-linear-v0", total_time_steps=T)
    S = E * T
    kw = dict(seed=5)
    if mode == "actions":
        rs = np.random.RandomState(1)
        act = (2 * rs.rand(S, cc.A, B) - 1).astype(np.float32)
        act[act < -0.5] = -1.0
        hi = max(c.maxv for c in cc.demand) + 1
        kw = dict(
            demands=torch.as_tensor(rs.randint(0, hi, size=(S, cc.R, cc.P, B))
                                    .astype(np.float32), device=dev),
            leadtimes=(torch.as_tensor(rs.randint(1, cc.Lmax + 1,
                                                  size=(S, cc.K, B))
                                       .astype(np.int32), device=dev)
                       if cc.stochastic_leadtimes else None),
            actions=torch.as_tensor(act, device=dev))
    desc = torch.as_tensor(scd.dense_descriptor(cc), device=dev)
    k = scd.launch_supplychain_dense(desc, cc, S, B, mode, **kw)
    p = scd.supplychain_dense_collect_plain(cc, E, B, mode, device=dev, **kw)
    assert float((k[0] - p[0]).abs().max()) <= 1e-6
    assert float((k[1] - p[1]).abs().max()) <= 1e-5 * float(p[1].abs().max())
    assert torch.equal(k[2], p[2])
    run = scd.make_supplychain_dense_collect(cc, T, B, mode=mode, episodes=E,
                                             device="cuda")
    before = launches("supplychain_dense")
    args = ((5,) if mode == "random" else
            tuple(x for x in (kw["demands"], kw["leadtimes"], kw["actions"])
                  if x is not None))
    obs, rew = run(*args)
    assert launches("supplychain_dense") == before + 1
    assert torch.equal(obs, k[0]) and torch.equal(rew, k[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,B", [("actions", 100), ("random", 100),
                                    ("actions", 8 * 12)])
def test_supplychain_dense_kernel_negative_values_and_ragged_batch(mode, B):
    """K5 on [5,4,7,10] x 4 (degrees 4, 7, 10 of Dmax 10) at a B that is no
    multiple of its 8 envs a block; in ``actions`` some actions below -1
    give negative values, so the degree elision falls back to all Dmax
    slots there.  Gates as above."""
    from gym_supplychain_tpu_torch.ops import supplychain_dense as scd

    dev = _device()
    T, E = 10, 2
    cc = make_chain("sc-Nperstage-multiproduct-v0",
                    nodes_per_echelon=[5, 4, 7, 10], num_products=4,
                    stochastic_leadtimes=True, total_time_steps=T)
    S = E * T
    kw = dict(seed=3)
    if mode == "actions":
        rs = np.random.RandomState(B)
        act = (3 * rs.rand(S, cc.A, B) - 2).astype(np.float32)   # [-2, 1)
        assert (act < -1).mean() > 0.2
        kw = dict(
            demands=torch.as_tensor(rs.randint(0, 25, size=(S, cc.R, cc.P, B))
                                    .astype(np.float32), device=dev),
            leadtimes=torch.as_tensor(rs.randint(1, cc.Lmax + 1,
                                                 size=(S, cc.K, B))
                                      .astype(np.int32), device=dev),
            actions=torch.as_tensor(act, device=dev))
    desc = torch.as_tensor(scd.dense_descriptor(cc), device=dev)
    k = scd.launch_supplychain_dense(desc, cc, S, B, mode, **kw)
    p = scd.supplychain_dense_collect_plain(cc, E, B, mode, device=dev, **kw)
    assert float((k[0] - p[0]).abs().max()) <= 1e-6
    assert float((k[1] - p[1]).abs().max()) <= 1e-5 * float(p[1].abs().max())
    assert torch.equal(k[2], p[2])
    assert bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("L,B", [(4, 300), (3, 300), (6, 257), (16, 64)])
@pytest.mark.parametrize("delay,init_delay", [(2, None), (0, 2), (3, 1)])
def test_beergame_episode_kernel_matches_plain(delay, init_delay, L, B):
    """K6b: bit-exact (integers), per-lane demand and initial inventory, at
    idle lanes in a group (3, 6 levels), 16 levels and ragged B."""
    from gym_supplychain_tpu_torch.ops import beergame_episode as bge

    dev = _device()
    W = 35
    rs = np.random.RandomState(4)
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    args = (put(rs.randint(0, 12, size=(W, B)).astype(np.int32)),
            put(rs.randint(0, 16, size=(W, L, B)).astype(np.int32)),
            put(rs.randint(0, 25, size=(L, B)).astype(np.int32)))
    kw = dict(delay=delay, init_delay=init_delay, init_ship=5, inv_cost=2,
              backlog_cost=3)
    before = launches("beergame_episode")
    k = bge.beergame_episode(*args, device="cuda", **kw)
    assert launches("beergame_episode") == before + 1
    p = bge.beergame_episode_plain(*args, **kw)
    assert k.device == args[0].device and torch.equal(k, p)


def test_policy_split_variants_apply_to_the_kernel_source():
    """``benchmarks/policy_split.py`` cuts the MLP and the env step out of
    the policy lane kernel by replacing texts of its source: every text is
    there, the MLP-less build runs neither net, the step-less one no
    ``ln_step``; both keep the rest of the source."""
    from gym_supplychain_tpu_torch.benchmarks import policy_split as ps
    from gym_supplychain_tpu_torch.ops import _build

    src = (_build.CSRC / "supplychain_policy.cu").read_text()
    out = ps.variant_sources()
    assert set(out) == {"no_mlp", "no_step"}
    assert out["no_mlp"].count("if (0) pl_net(") == 2
    assert "mu_s[i * E + e])" not in out["no_mlp"]
    assert out["no_step"].count("r = act[0];") == 2
    assert "ln_step<G, DT>(" not in out["no_step"]
    for text in out.values():
        assert text != src and text.count("\n") == src.count("\n")


_PTXAS = """\
ptxas info    : Compiling entry function '_Z17ppo_reduce_kernelPKfiiPf' for 'sm_90a'
ptxas info    : Function properties for _Z17ppo_reduce_kernelPKfiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z15ppo_grad_kernelPKiPKfS2_iffPf' for 'sm_90a'
ptxas info    : Function properties for _Z15ppo_grad_kernelPKiPKfS2_iffPf
    192 bytes stack frame, 232 bytes spill stores, 296 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 832 bytes smem
ptxas info    : Compiling entry function '_Z15sc_dense_kernelILi16ELi10EEvPK6ChainTILi64EEiPf' for 'sm_90a'
ptxas info    : Function properties for _Z15sc_dense_kernelILi16ELi10EEvPK6ChainTILi64EEiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 165 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZL14sc_lane_kernelILi8ELi8ELi2ELi1EEvPK6ChainTILi64EEiPf' for 'sm_90a'
ptxas info    : Function properties for _ZL14sc_lane_kernelILi8ELi8ELi2ELi1EEvPK6ChainTILi64EEiPf
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
"""


def test_ptxas_report_reads_the_build_report(tmp_path, monkeypatch):
    """``ptxas_report`` (printed by chip_smoke.py's phase 1) picks each
    entry function's registers, spills and stack out of ptxas's report,
    template instances named by their arguments."""
    from gym_supplychain_tpu_torch.ops import _build

    (tmp_path / "ppo_update.ptxas.txt").write_text(_PTXAS)
    monkeypatch.setattr(_build, "_lib", object())
    monkeypatch.setattr(_build, "_lib_dir", tmp_path)
    assert _build.ptxas_report("ppo_grad_kernel") == [dict(
        function="ppo_grad_kernel", registers=128, spill_stores=232,
        spill_loads=296, stack=192)]
    assert _build.ptxas_report("sc_dense_kernel") == [dict(
        function="sc_dense_kernel<16,10>", registers=165, spill_stores=0,
        spill_loads=0, stack=0)]
    assert _build.ptxas_report("sc_lane_kernel") == [dict(
        function="sc_lane_kernel<8,8,2,1>", registers=72, spill_stores=0,
        spill_loads=0, stack=8)]
    assert _build.ptxas_report("bg_collect_kernel") == []
