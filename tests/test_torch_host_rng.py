"""The port's host MT19937 streams against the JAX package's, bit for bit.

``rng/host.py`` (``generate_demand``, ``HostEpisodeRNG``, ``BatchHostRNG``),
``rng/gym_compat.py`` and the native batch generator are the port's own
copies of numpy-only modules of the JAX package.  Every demand process
(uniform, normal, seasonal with a normal, an integer or no perturbation,
a process per product) and stochastic lead-times are drawn over two
consecutive episodes, so that stream continuation is covered; the native
backend must equal the NumPy backend and ``np.random.RandomState``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.rng import gym_compat as jgc  # noqa: E402
from gym_supplychain_tpu.rng import host as jhost  # noqa: E402

from gym_supplychain_tpu_torch import make_chain, native  # noqa: E402
from gym_supplychain_tpu_torch.rng import gym_compat as tgc  # noqa: E402
from gym_supplychain_tpu_torch.rng import host as thost  # noqa: E402

T = 9
# id, keyword arguments: the demand processes of the reference
CASES = {
    "uniform, stochastic lead-times": ("supplychain-ntom-v0", {}),
    "normal, stochastic lead-times": ("supplychain-linear-v0", dict(
        demand_std=1.5, stochastic_leadtimes=True, max_leadtime=4)),
    "seasonal, normal perturbation": ("sc-2perstage-seasonal-v0", {}),
    "seasonal, integer perturbation": ("sc-2perstage-seasonal-v0", dict(
        demand_perturb_norm=False)),
    "per product: seasonal-normal, normal": (
        "sc-2perstage-multiproduct-v1", dict(demand_std=10,
                                             demand_perturb_norm=True)),
    "per product: seasonal, uniform, seasonal": (
        "sc-2perstage-multiproduct-v1", dict(num_products=3)),
}


def _chains(case):
    env_id, kw = CASES[case]
    return (make_chain(env_id, total_time_steps=T, **kw),
            jsct.make(env_id, total_time_steps=T, **kw).cc)


def _equal(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("case", sorted(CASES))
def test_episode_tables_match_jax(case):
    cc, jcc = _chains(case)
    port, ref = thost.HostEpisodeRNG(cc, 7), jhost.HostEpisodeRNG(jcc, 7)
    for _ in range(2):                    # the second continues the stream
        for got, want in zip(port.episode_tables(), ref.episode_tables()):
            _equal(got, want)
    for got, want in zip(port.batch_tables(3), ref.batch_tables(3)):
        _equal(got, want)
    port.seed(7)
    ref.seed(7)
    _equal(port.episode_tables()[0], ref.episode_tables()[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_host_rng_matches_jax_and_numpy(case, monkeypatch):
    cc, jcc = _chains(case)
    seeds = [3, 4, 2 ** 32 - 1]
    port, ref = thost.BatchHostRNG(cc, seeds), jhost.BatchHostRNG(jcc, seeds)
    assert port.backend == ("native" if native.available() else "numpy")
    monkeypatch.setattr(native, "available", lambda: False)
    fallback = thost.BatchHostRNG(cc, seeds)
    assert fallback.backend == "numpy"
    singles = [thost.HostEpisodeRNG(cc, s) for s in seeds]
    for _ in range(2):
        want = ref.episode_tables()
        for got in (port.episode_tables(), fallback.episode_tables()):
            for g, w in zip(got, want):
                _equal(g, w)
        for b, single in enumerate(singles):
            d, lt = single.episode_tables()
            np.testing.assert_array_equal(want[0][..., b], d)
            if lt is not None:
                np.testing.assert_array_equal(want[1][..., b], lt)


@pytest.mark.parametrize("args", [
    (0, 5), (0, 400, 10.0), (0, 400, 10.0, 4, 150, 250, True),
    (0, 400, 2, 2, 100, 300, False), (0, 400, None, 4, 100, 300, False)])
def test_generate_demand_reference_surface(args):
    """The reference's flat ``(minv, maxv, std, sen_peaks, minavg, maxavg,
    perturb_norm)`` arguments, and a ``DemandConfig``, on both."""
    shape = (T + 1, 2, 3)
    flat = dict(zip(("cfg", "maxv", "std", "sen_peaks", "minavg", "maxavg",
                     "perturb_norm"), args))
    got = thost.generate_demand(np.random.RandomState(5), shape, T, **flat)
    want = jhost.generate_demand(np.random.RandomState(5), shape, T, **flat)
    _equal(got, want)


def test_gym_compat_matches_jax():
    for seed in (0, 1, 12345, 2 ** 40 + 3):
        assert tgc.hash_seed(seed) == jgc.hash_seed(seed)
        assert tgc.create_seed(seed) == jgc.create_seed(seed)
        np.testing.assert_array_equal(tgc.old_gym_np_random(seed).rand(7),
                                      jgc.old_gym_np_random(seed).rand(7))
    a, b = tgc.OldGymBox(-1.0, 1.0, (5,)), jgc.OldGymBox(-1.0, 1.0, (5,))
    a.seed(0)
    b.seed(0)
    for _ in range(3):
        x = a.sample()
        np.testing.assert_array_equal(x, b.sample())
        assert x.dtype == np.float32 and a.contains(x)


def test_native_streams_match_numpy():
    """randint (32- and 64-bit ranges), normal (polar with its cache) and
    poisson (multiplication and PTRS) equal ``np.random.RandomState``,
    interleaved in one stream."""
    if not native.available():
        pytest.fail(f"the native generator did not build: "
                    f"{native.build_error()}")
    seeds = [0, 1, 5, 42, 12345, 4294967295]
    rng = native.NativeBatchRNG(seeds)
    got = [rng.randint(0, 6, 20), rng.normal(150, 10, 15),
           rng.poisson(1.0, 30), rng.randint(-15, 16, 10),
           rng.poisson(25.0, 10), rng.randint(0, 2 ** 40, 5),
           rng.randint(10, 21, 9), rng.normal(0, 20, 7)]
    for i, seed in enumerate(seeds):
        rs = np.random.RandomState(seed)
        want = [rs.randint(0, 6, 20), rs.normal(150, 10, 15),
                rs.poisson(1.0, 30), rs.randint(-15, 16, 10),
                rs.poisson(25.0, 10), rs.randint(0, 2 ** 40, 5),
                rs.randint(10, 21, 9), rs.normal(0, 20, 7)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i], w)
    assert native.library_path().exists()
