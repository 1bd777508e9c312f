"""The port's CUDA collect kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device.  The file
imports no jax, so it runs on a machine with the card but without jax:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances: supply chain obs atol 1e-6 and rewards atol 1e-5 * max|r| (the
costs are summed in another order), stock bit-equal (the dynamics follow
the same op sequence with no FMA); beer game bit-exact (integers).
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
