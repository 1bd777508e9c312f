"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device.  The file
imports no jax, so it runs on a machine with the card but without jax:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances: supply chain obs atol 1e-6 and rewards atol 1e-5 * max|r| (the
costs are summed in another order), stock bit-equal (the dynamics follow
the same op sequence with no FMA); beer game bit-exact (integers); the
policy modes' pre, logp and value at the JAX collect tests' tolerances; the
update kernel's gradients within 4x the plain float32 error against float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.ops import beergame_collect as bgc  # noqa: E402
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402


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
    desc = torch.as_tensor(scc.chain_descriptor(cc), device=dev)
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
    before = scc.launch_supplychain_collect.launches
    k = scc.launch_supplychain_collect(desc, cc, S, B, mode, **kw)
    assert scc.launch_supplychain_collect.launches == before + 1
    p = scc.supplychain_collect_plain(cc, E, B, mode, device=dev, **kw)
    assert float((k[0] - p[0]).abs().max()) <= 1e-6
    assert float((k[1] - p[1]).abs().max()) <= 1e-5 * float(p[1].abs().max())
    assert torch.equal(k[2], p[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["v0 random", "v0 actions", "v2 per-lane"])
def test_beergame_kernel_matches_plain(case):
    dev = _device()
    W, L, B, E = 35, 4, 256, 2
    S = E * W
    rs = np.random.RandomState(3)
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    kw = dict(mode="random", seed=9,
              demand=put(rs.randint(0, 12, size=(S, B)).astype(np.int32)))
    if case != "v0 random":
        kw.update(mode="actions", seed=0, actions=put(
            rs.randint(0, 20, size=(S, L, B)).astype(np.int32)))
    if case == "v2 per-lane":
        kw.update(delay=None, max_delay=4, v2=True, max_stock=40,
                  exceeded_capacity_penalty=37,
                  delays=put(rs.randint(0, 5, size=(S, B)).astype(np.int32)))
    k = bgc.launch_beergame_collect(W, L, B, E, **kw)
    p = bgc.beergame_collect_plain(W, L, B, E, **kw)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_wrappers_launch_the_kernels_for_cuda_devices():
    _device()
    cc = make_chain("supplychain-linear-v0", total_time_steps=6)
    before = scc.launch_supplychain_collect.launches
    obs, rew = scc.make_supplychain_collect(cc, 6, 64, mode="random",
                                            episodes=2, device="cuda")(1)
    assert scc.launch_supplychain_collect.launches == before + 1
    assert obs.is_cuda and obs.shape == (12, cc.obs_dim, 64)
    before = bgc.launch_beergame_collect.launches
    spec = make_chain("beergame-v0")
    obs, rew = bgc.make_beergame_collect(spec.weeks, spec.levels, 64,
                                         device="cuda")(spec.demand, 1)
    assert bgc.launch_beergame_collect.launches == before + 1
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
    before = scc.launch_supplychain_policy.launches
    k = run(*args)
    assert scc.launch_supplychain_policy.launches == before + 1
    p = scc.supplychain_collect_plain(
        cc, E, B, mode, seed=seed, params=model, sample_major=sample_major,
        device=dev, **({} if mode == "policy" else dict(
            demands=dem, leadtimes=lt, eps=eps)))
    assert float((k[0] - p[0]).abs().max()) <= 1e-6
    assert float((k[1] - p[1]).abs().max()) <= 1e-4
    assert torch.allclose(k[2], p[2], rtol=1e-4, atol=1e-3)
    assert float((k[3] - p[3]).abs().max()) <= 1e-4
    assert float((k[4] - p[4]).abs().max()) <= 1e-5 * float(p[4].abs().max())


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
    gf = pu.make_ppo_update_grads(O, A, hidden, M)
    before = pu.launch_ppo_update.launches
    lk, gk = gf(model, *data)
    lk2, gk2 = gf(model, *data)
    assert pu.launch_ppo_update.launches == before + 2
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
def test_fused_trainer_launches_both_kernels():
    from gym_supplychain_tpu_torch.learn.ppo import PPOConfig, make_ppo_fused
    from gym_supplychain_tpu_torch.ops import ppo_update as pu

    _device()
    cc = make_chain("supplychain-ntom-v0", total_time_steps=10)
    init_fn, train_step = make_ppo_fused(
        cc, 64, PPOConfig(hidden=(16, 16), epochs=2, fused_update=True),
        device="cuda")
    k1 = scc.launch_supplychain_policy.launches
    k2 = pu.launch_ppo_update.launches
    state, metrics = train_step(init_fn(0))
    assert scc.launch_supplychain_policy.launches == k1 + 1
    assert pu.launch_ppo_update.launches == k2 + 2
    assert bool(torch.isfinite(metrics["loss"]))
