"""The kernels' demand draw and the demand presets, against the JAX package.

* ``demand_from_uniforms`` (the kernel form of the draw, what the CUDA
  collect kernels compute in ``ln_demand``) against the JAX package's
  ``_demand_from_u`` on the same float32 uniforms, for each of the five
  demand processes at several steps of the episode: the integers must be
  equal.  The one exception allowed is an entry whose pre-round value lies
  within 1e-4 of a half-integer or of a clip edge, where XLA:CPU's and
  PyTorch's transcendentals may differ by an ulp: it may differ by exactly
  1, and at most 1e-4 of the entries may.
* The Box-Muller demand and the seasonal processes at a fixed step, on
  10^6 Philox uniforms, against their analytic PMFs within
  ``ATOL_HOST`` = 3.2e-3 (about 6.4 binomial sigma at p = 0.5, as
  ``tests/test_rng_distribution.py``).
* The seasonal chain's rows follow one base at steps te and te + T.
* The plain ``actions`` collection on the rows ``philox_tables`` draws
  against ``make_supplychain_collect_pallas(..., mode="actions",
  interpret=True)`` over two episodes: obs atol 1e-6, rewards atol
  1e-5 * max|r| (``tests/test_torch_collect.py``'s).
* The new presets equal the JAX package's, field by field, and the train,
  evaluate and compare CLIs take their ids.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.envs.presets import _linear_nodes  # noqa: E402
from gym_supplychain_tpu.ops.supplychain_pallas import (  # noqa: E402
    _demand_from_u, make_supplychain_collect_pallas)

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.core.compile import DemandConfig  # noqa: E402
from gym_supplychain_tpu_torch.learn import (  # noqa: E402
    compare_baseline, evaluate, train)
from gym_supplychain_tpu_torch.ops import supplychain_collect as scc  # noqa: E402
from gym_supplychain_tpu_torch.rng.device import (  # noqa: E402
    demand_from_uniforms, philox_uniform)

ATOL_HOST = 3.2e-3
T = 360
# the five processes, each with clip edges its draws reach
PROCESSES = {
    "uniform": DemandConfig(0, 400),
    "normal": DemandConfig(10, 20, std=3.7),
    "seasonal normal": DemandConfig(0, 400, std=40.0, sen_peaks=4, minavg=20,
                                    maxavg=380, perturb_norm=True),
    "seasonal uniform": DemandConfig(0, 400, std=30, sen_peaks=2, minavg=0,
                                     maxavg=400),
    "seasonal, no perturbation": DemandConfig(0, 400, sen_peaks=4,
                                              minavg=150, maxavg=250),
}


def _uniforms(cfg, n, seed):
    """``n`` float32 uniforms and partners on the kernels' 2^-23 grid, then
    crafted edges: 0, 1 - 2^-24, and pairs whose normal lands near a clip
    edge (the normal's own at step 0, with cos = +-1)."""
    rs = np.random.RandomState(seed)
    u, u2 = (rs.randint(0, 2 ** 23, n) / 2 ** 23 for _ in range(2))
    eu, eu2 = [], []
    for a in (0.0, 2 ** -24, 0.5, 1 - 2 ** -24):
        for b in (0.0, 0.25, 0.5, 1 - 2 ** -24):
            eu.append(a)
            eu2.append(b)
    if cfg.std:
        centre = ((cfg.maxv + cfg.minv) / 2 if cfg.sen_peaks is None
                  else (cfg.minavg + cfg.maxavg) / 2)
        for edge in (cfg.minv, cfg.maxv):
            z = (edge - centre) / cfg.std
            if 0 < abs(z) < 5.7:
                # u whose radius is |z|, and its 3 float32 neighbours a side
                lo = hi = np.float32(-math.expm1(-z * z / 2))
                near = [lo]
                for _ in range(3):
                    lo = np.nextafter(lo, np.float32(0))
                    hi = np.nextafter(hi, np.float32(1))
                    near += [lo, hi]
                eu += [float(x) for x in near]
                eu2 += [0.0 if z > 0 else 0.5] * len(near)
    return (np.concatenate([u, eu]).astype(np.float32),
            np.concatenate([u2, eu2]).astype(np.float32))


def _pre_round(cfg, u, u2, te):
    """The draw before its clip and round, in float64."""
    u, u2 = u.astype(np.float64), u2.astype(np.float64)
    std = cfg.std or 0.0
    z = np.sqrt(-2 * np.log1p(-u)) * np.cos(2 * np.pi * u2)
    if cfg.sen_peaks is None:
        if cfg.std is None:
            return np.floor(u * (cfg.maxv - cfg.minv + 1)) + cfg.minv
        return z * std + (cfg.maxv + cfg.minv) / 2
    base = cfg.minavg + (cfg.maxavg - cfg.minavg) / 2 * (
        1 + np.sin(cfg.sen_peaks * 2 * np.pi * te / T))
    if cfg.perturb_norm:
        return base + z * std
    lo, hi = int(-3 * std), int(3 * std)
    return base + np.floor(u * (hi - lo + 1)) + lo


@pytest.mark.parametrize("process", sorted(PROCESSES))
def test_draw_matches_jax(process):
    """Integers equal to ``_demand_from_u``'s; an entry within 1e-4 of a
    half-integer or a clip edge before its round may differ by exactly 1,
    at most 1e-4 of the entries (the count is printed)."""
    cfg = PROCESSES[process]
    u, u2 = _uniforms(cfg, 100_000, seed=len(process))
    total = odd = 0
    for te in (0, 1, 45, 90, 181, 359):
        want = np.asarray(_demand_from_u(jnp.asarray(u), jnp.asarray(u2), cfg,
                                         jnp.int32(te), T))
        got = demand_from_uniforms(torch.from_numpy(u), torch.from_numpy(u2),
                                   cfg, te, T).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, np.round(got))
        assert (got >= cfg.minv).all() and (got <= cfg.maxv).all()
        diff = got != want
        if diff.any():
            x = _pre_round(cfg, u[diff], u2[diff], te)
            tie = (np.abs(x - np.floor(x) - 0.5) < 1e-4) | (
                np.abs(x - cfg.minv) < 1e-4) | (np.abs(x - cfg.maxv) < 1e-4)
            assert tie.all(), (te, u[diff][~tie], u2[diff][~tie])
            assert (np.abs(got[diff] - want[diff]) == 1).all()
        odd += int(diff.sum())
        total += u.size
    print(f"{process}: {odd} of {total} entries differ by 1 at a tie")
    assert odd <= 1e-4 * total


def _philox_pairs(n, seed):
    u = philox_uniform((seed, 7), [0], 2, n, "cpu")[0]
    return u[0], u[1]


def _normal_cdf(x):
    return np.array([0.5 * (1 + math.erf(v / math.sqrt(2))) for v in x])


def _rounded_normal_pmf(mean, std, lo, hi):
    """PMF over lo..hi of round(clip(mean + std * N(0, 1), lo, hi))."""
    k = np.arange(lo, hi + 1, dtype=np.float64)
    upper = _normal_cdf((k + 0.5 - mean) / std)
    lower = _normal_cdf((k - 0.5 - mean) / std)
    upper[-1], lower[0] = 1.0, 0.0
    return upper - lower


def _hist(d, lo, hi):
    return np.bincount(d.astype(np.int64) - lo,
                       minlength=hi - lo + 1) / d.size


@pytest.mark.parametrize("cfg", [DemandConfig(10, 20, std=3.7),
                                 DemandConfig(0, 400, std=10.0)])
def test_box_muller_demand_distribution(cfg):
    """Normal demand from Box-Muller on 10^6 Philox pairs against the
    rounded, clipped normal PMF, each outcome within ``ATOL_HOST``."""
    u, u2 = _philox_pairs(1_000_000, seed=1)
    d = demand_from_uniforms(u, u2, cfg, 0, T).numpy()
    pmf = _rounded_normal_pmf((cfg.maxv + cfg.minv) / 2, cfg.std, cfg.minv,
                              cfg.maxv)
    assert np.abs(_hist(d, cfg.minv, cfg.maxv) - pmf).max() < ATOL_HOST


@pytest.mark.parametrize("te", [0, 23, 200])
def test_seasonal_distribution_at_a_fixed_step(te):
    """The seasonal processes at step te, on 10^6 Philox pairs: with a
    normal perturbation against the rounded, clipped normal PMF around the
    base, with a uniform one against the base plus each of its 61 integers
    in [-30, 30], within ``ATOL_HOST``."""
    u, u2 = _philox_pairs(1_000_000, seed=te)
    base = 100 + 150 * (1 + math.sin(4 * 2 * math.pi * te / T))
    cfg = DemandConfig(0, 400, std=10.0, sen_peaks=4, minavg=100, maxavg=400,
                       perturb_norm=True)
    d = demand_from_uniforms(u, u2, cfg, te, T).numpy()
    assert np.abs(_hist(d, 0, 400)
                  - _rounded_normal_pmf(base, 10.0, 0, 400)).max() < ATOL_HOST
    cfg = dataclasses.replace(cfg, perturb_norm=False)
    d = demand_from_uniforms(u, None, cfg, te, T).numpy()
    pmf = np.zeros(401)
    for k in range(-30, 31):
        pmf[int(np.round(np.clip(base + k, 0, 400)))] += 1 / 61
    assert np.abs(_hist(d, 0, 400) - pmf).max() < ATOL_HOST


def test_seasonal_rows_follow_the_base_each_episode():
    """Without a perturbation (std None) the seasonal chain's demand is its
    base: every lane's row at step te of any episode equals
    ``_demand_from_u``'s at te, and steps of an episode differ."""
    Tc, B, E, seed = 20, 3, 2, 5
    cc = make_chain("sc-2perstage-seasonal-v0", total_time_steps=Tc,
                    demand_std=None)
    dem, _, _ = scc.philox_tables(cc, seed, range(E * Tc), B, "cpu")
    assert torch.equal(dem[:Tc], dem[Tc:])
    assert not torch.equal(dem[0], dem[Tc // 8])
    for te in range(Tc):
        want = np.asarray(_demand_from_u(jnp.zeros(1, jnp.float32),
                                         jnp.zeros(1, jnp.float32),
                                         cc.demand[0], jnp.int32(te), Tc))
        assert (dem[te].numpy() == want[0]).all()
    # with the perturbation (std 10) each entry lies within the reach of a
    # Box-Muller normal of 2^-23-grid uniforms (|z| < 5.8) of its base
    cc = make_chain("sc-2perstage-seasonal-v0", total_time_steps=Tc)
    noisy, _, _ = scc.philox_tables(cc, seed, range(E * Tc), 64, "cpu")
    assert not torch.equal(noisy[:Tc], noisy[Tc:])
    assert float((noisy[:, :, :, :B] - dem).abs().max()) <= 10 * 5.8 + 1


def _check_against_jax_kernel(cc, T_, B, E, tables):
    jax_run = make_supplychain_collect_pallas(cc, T_, B, mode="actions",
                                              episodes=E, interpret=True)
    want_obs, want_rew = [np.asarray(x) for x in jax_run(*tables)]
    run = scc.make_supplychain_collect(cc, T_, B, mode="actions", episodes=E,
                                       device="cpu")
    obs, rew = run(*tables)
    np.testing.assert_allclose(obs.numpy(), want_obs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rew.numpy(), want_rew, rtol=0,
                               atol=1e-5 * np.abs(want_rew).max())


# horizons off the ring's multiple keep the interpreted JAX kernel quick
@pytest.mark.filterwarnings("ignore:collect horizon")
@pytest.mark.parametrize("env_id,kw,T_", [
    ("sc-2perstage-seasonal-v0", {}, 3),
    ("sc-2perstage-multiproduct-inccosts-v1", dict(demand_std=10), 3)])
def test_plain_actions_on_drawn_rows_matches_jax_kernel(env_id, kw, T_):
    """The port's Philox rows (as numpy) through the JAX kernel's
    ``actions`` mode and the plain ``actions``, two episodes."""
    B, E, seed = 4, 2, 9
    cc = make_chain(env_id, total_time_steps=T_, **kw)
    dem, lt, act = scc.philox_tables(cc, seed, range(E * T_), B, "cpu")
    tables = [dem.numpy()] + ([lt.numpy()] if lt is not None else []) + [
        act.numpy()]
    _check_against_jax_kernel(jsct.make(env_id, total_time_steps=T_, **kw).cc,
                              T_, B, E, tables)


@pytest.mark.filterwarnings("ignore:collect horizon")
def test_oneonen_three_retailers_matches_jax_kernel():
    """``supplychain-oneonen-v0`` at 3 retailers: the wholesaler's sorted
    cut over D = 3 destinations, plain ``actions`` against the JAX kernel
    on random tables (some actions -1, so supplies do not fire)."""
    T_, B, E = 4, 4, 2
    cc = jsct.make("supplychain-oneonen-v0", num_retailers=3,
                   total_time_steps=T_).cc
    assert cc.Dmax == 3 and cc.R == 3
    rs = np.random.RandomState(3)
    act = (2 * rs.rand(E * T_, cc.A, B) - 1).astype(np.float32)
    act[act < -0.5] = -1.0
    dem = rs.randint(0, 25, size=(E * T_, cc.R, cc.P, B)).astype(np.float32)
    _check_against_jax_kernel(cc, T_, B, E, [dem, act])


@pytest.mark.parametrize("env_id,kw", [
    ("sc-2perstage-seasonal-v0", {}),
    ("sc-2perstage-seasonal-v0", dict(demand_std=10,
                                      demand_perturb_norm=False)),
    ("sc-2perstage-seasonal-v0", dict(demand_std=None)),
    ("sc-2perstage-multiproduct-v1", dict(num_products=1)),
    ("sc-2perstage-multiproduct-v1", dict(num_products=2, demand_std=10)),
    ("sc-2perstage-multiproduct-v1", dict(num_products=3, demand_std=10,
                                          demand_perturb_norm=True)),
    ("sc-2perstage-multiproduct-inccosts-v1", dict(num_products=1,
                                                   demand_std=10)),
    ("sc-2perstage-multiproduct-inccosts-v1", dict(num_products=2)),
    ("sc-2perstage-multiproduct-inccosts-v1", dict(
        num_products=3, demand_std=10, demand_perturb_norm=True)),
    ("supplychain-oneonen-v0", dict(num_retailers=3, demand_std=10)),
    ("supplychain-v0", dict(nodes_info=_linear_nodes(), demand_std=10,
                            demand_sen_peaks=3, avg_demand_range=(5, 15)))])
def test_presets_match_jax(env_id, kw):
    got, want = make_chain(env_id, **kw), jsct.make(env_id, **kw).cc
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "demand":
            assert [dataclasses.asdict(x) for x in a] == \
                [dataclasses.asdict(x) for x in b]
        else:
            assert a == b, f.name


@pytest.mark.parametrize("env_id", ["sc-2perstage-seasonal-v0",
                                    "sc-2perstage-multiproduct-v1",
                                    "sc-2perstage-multiproduct-inccosts-v1",
                                    "supplychain-oneonen-v0"])
def test_clis_take_the_new_ids(env_id, tmp_path, capsys):
    """The train CLI (fused collection, as on the card), the evaluate CLI
    with both engines and the comparison CLI run on each id that needs no
    ``nodes_info`` (``supplychain-v0`` needs one, so no CLI takes it)."""
    ck = str(tmp_path / "ck")
    env = ["--env", env_id, "--device", "cpu"]
    train.main(env + ["--envs", "3", "--hidden", "8", "--horizon", "4",
                      "--iters", "1", "--log-every", "1", "--fused",
                      "--fused-update", "--checkpoint-dir", ck])
    got = [evaluate.main(env + ["--restore", ck, "--envs", "3", "--horizon",
                                "4", "--episodes", "1", "--engine", engine])
           for engine in ("kernel", "scan")]
    assert all(math.isfinite(s["mean_return"]) for s in got)
    assert abs(got[0]["mean_return"] - got[1]["mean_return"]) <= 1e-5 * abs(
        got[1]["mean_return"])
    report = compare_baseline.main(env + [
        "--horizon", "4", "--envs", "3", "--iters", "1", "--rollout", "2",
        "--epochs", "1", "--hidden", "8", "--eval-episodes", "1", "--zs",
        "1.0"])
    assert report["env"] == env_id
    capsys.readouterr()
