"""Beer-game episode sweep (K6b): its plain version against the JAX kernel.

``beergame_episode`` on the CPU (the plain version, what the wrapper runs
for CPU tensors) must equal ``beergame_episode_pallas(..., interpret=True)``
bit for bit (int32) on the cases of ``tests/test_pallas_ops.py``: the
defaults, custom costs with delay 3 and a per-level inventory, and delay 0
with an initial delay of 2; and on a per-lane inventory and demand.  The
CUDA kernel is compared with the plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 12).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu.ops.beergame_pallas import (  # noqa: E402
    beergame_episode_pallas)

from gym_supplychain_tpu_torch.ops import beergame_episode as bge  # noqa: E402
from gym_supplychain_tpu_torch.utils.profiling import counters  # noqa: E402


def _case(name):
    if name == "defaults":
        W, L, B = 35, 4, 8
        rs = np.random.RandomState(0)
        dem = np.array([4] * 4 + [8] * (W - 4), np.int32)
        act = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
        inv0 = np.full((L, B), 12, np.int32)
        return dem, act, inv0, {}
    if name == "custom costs, delay 3":
        W, L, B = 20, 3, 4
        rs = np.random.RandomState(5)
        dem = rs.randint(0, 10, size=W).astype(np.int32)
        act = rs.randint(0, 9, size=(W, L, B)).astype(np.int32)
        inv0 = np.broadcast_to(np.array([[5], [9], [13]], np.int32),
                               (L, B)).copy()
        return dem, act, inv0, dict(delay=3, init_ship=6, init_orders=2,
                                    inv_cost=2, backlog_cost=7)
    if name == "delay 0, init_delay 2":
        W, L, B = 12, 4, 4
        rs = np.random.RandomState(11)
        dem = rs.randint(0, 10, size=W).astype(np.int32)
        act = rs.randint(0, 9, size=(W, L, B)).astype(np.int32)
        inv0 = np.full((L, B), 12, np.int32)
        return dem, act, inv0, dict(delay=0, init_delay=2)
    # per-lane demand and inventory, a longer initial delay
    W, L, B = 15, 5, 6
    rs = np.random.RandomState(13)
    dem = rs.randint(0, 12, size=(W, B)).astype(np.int32)
    act = rs.randint(0, 12, size=(W, L, B)).astype(np.int32)
    inv0 = rs.randint(0, 30, size=(L, B)).astype(np.int32)
    return dem, act, inv0, dict(delay=1, init_delay=3)


@pytest.mark.parametrize("name", ["defaults", "custom costs, delay 3",
                                  "delay 0, init_delay 2",
                                  "per-lane demand and inventory"])
def test_plain_matches_jax_kernel_bit_for_bit(name):
    dem, act, inv0, kw = _case(name)
    W, L, B = act.shape
    dem2 = dem if dem.ndim == 2 else np.broadcast_to(dem[:, None],
                                                     (W, B)).copy()
    want = np.asarray(beergame_episode_pallas(dem2, act, inv0,
                                              interpret=True, **kw))
    got = bge.beergame_episode(dem2, act, inv0, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (W, B)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks():
    act = torch.zeros((4, 2, 3), dtype=torch.int32)
    dem = torch.zeros((4, 3), dtype=torch.int32)
    inv = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bge.launch_beergame_episode(dem, act, inv)
    with pytest.raises(ValueError, match=">= 0"):
        bge.beergame_episode(dem, act, inv, delay=-1, device="cpu")
    with pytest.raises(ValueError, match="sweep on cpu"):
        bge.beergame_episode(dem.to("meta"), act, inv, device="cpu")
    # a launch never happens for CPU tensors
    before = counters().get("launch.beergame_episode", 0)
    bge.beergame_episode(dem, act, inv, device="cpu")
    assert counters().get("launch.beergame_episode", 0) == before
