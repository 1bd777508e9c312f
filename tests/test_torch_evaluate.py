"""The evaluation slice: evaluators, episode tables, base-stock baselines.

* The port's fused evaluator fed the JAX evaluator's own tables
  (``jax.random.split`` -> ``device_demand_tables`` /
  ``device_leadtime_tables``, as ``gym_supplychain_tpu/learn/evaluate.py``
  draws them) against the JAX computation of those lines with the
  interpreted kernel: the return statistics within 1e-5 relative (the
  per-step rewards agree to a few 1e-7 of max|r|, then T of them are
  summed).
* The scan and kernel evaluators of the port see the same inputs for the
  same key: their statistics agree within 1e-5 relative (the scan
  evaluator's actor is a matmul, the kernel's an ordered accumulation, so
  the actions differ by ulps).
* ``device_episode_tables`` holds exactly the rows ``stateless_step_rows``
  draws, with the exact marginals.
* The base-stock policy's actions against the JAX policy on the same state,
  atol 1e-6 (JAX promotes to float64 with x64 on); targets and mean demand
  equal.
* The evaluate and compare CLIs end to end on the CPU, and every public
  constructor of the port defaults to the card.
* The episode-table kernel (``ops/episode_tables.py``): on the CPU the
  draw takes the plain path and launches nothing, the wrapper refuses
  tables of another device, shape or dtype, and the descriptor read as the
  kernel reads it gives the plain tables; on the card (marked ``cuda``) the
  kernel's tables equal the plain draw's bit for bit, one launch a draw, at
  any horizon.

The JAX package is imported inside the tests that compare with it, so the
card's part runs where there is no jax:

    python -m pytest tests/test_torch_evaluate.py -m cuda --noconftest -q
"""
import inspect
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu_torch as tsct  # noqa: E402
from gym_supplychain_tpu_torch.core.step import state_from_numpy  # noqa: E402
from gym_supplychain_tpu_torch.learn import (  # noqa: E402
    compare_baseline, evaluate, heuristics, train)
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    ActorCritic, MLPConfig, params_from_jax)
from gym_supplychain_tpu_torch.ops import episode_tables as et  # noqa: E402
from gym_supplychain_tpu_torch.rng.device import (  # noqa: E402
    device_demand_tables, device_episode_tables, device_leadtime_tables,
    episode_tables_plain, philox_uniform, poisson_clip_thresholds,
    stateless_step_rows)
from gym_supplychain_tpu_torch.utils.profiling import (  # noqa: E402
    counters, reset_counters)


def _tree(cc, hidden, seed, mu_scale=100.0):
    import jax
    from gym_supplychain_tpu.models.policy import (
        MLPConfig as JMLPConfig, init_actor_critic)

    params = init_actor_critic(jax.random.PRNGKey(seed),
                               JMLPConfig(cc.obs_dim, cc.A, hidden))
    params["mu"]["w"] = params["mu"]["w"] * mu_scale
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _stats_close(got, want, rtol=1e-5):
    for k in ("mean_return", "std_return", "min_return", "max_return"):
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= rtol * abs(w), (k, g, w)


@pytest.mark.parametrize("env_id,T,B,hidden,episodes", [
    ("supplychain-ntom-v0", 12, 4, (16,), 2),
    ("supplychain-linear-v0", 10, 6, (16, 16), 1)])
def test_fused_evaluator_matches_jax_on_its_tables(env_id, T, B, hidden,
                                                   episodes):
    import jax
    import gym_supplychain_tpu as jsct
    from gym_supplychain_tpu.ops.supplychain_pallas import (
        make_supplychain_policy_rollout_pallas)
    from gym_supplychain_tpu.rng import device as jrng

    cc = jsct.make(env_id, total_time_steps=T).cc
    tree = _tree(cc, hidden, 5)
    run = make_supplychain_policy_rollout_pallas(cc, T, B, hidden=hidden,
                                                 interpret=True)
    tables, per_env = [], []
    # gym_supplychain_tpu/learn/evaluate.py:71-80, one episode a key
    for k in jax.random.split(jax.random.PRNGKey(3), episodes):
        kd, kl = jax.random.split(k)
        dem = np.asarray(jrng.device_demand_tables(kd, cc, B))
        lt = (np.asarray(jrng.device_leadtime_tables(kl, cc, B))
              if cc.stochastic_leadtimes else None)
        args = (dem, lt) if lt is not None else (dem,)
        per_env.append(np.asarray(run(*args, tree)).sum(axis=0))
        tables.append((torch.tensor(dem),
                       None if lt is None else torch.tensor(lt)))
    per_env = np.stack(per_env)
    want = {"mean_return": per_env.mean(), "std_return": per_env.std(),
            "min_return": per_env.min(), "max_return": per_env.max()}
    ev = evaluate.make_fused_evaluator(
        cc, B, hidden, device="cpu",
        draw_tables=lambda ep_key: tables[ep_key[1] - 7])
    got = ev(params_from_jax(tree, device="cpu"), (0, 7), episodes)
    _stats_close(got, want)


def test_scan_and_kernel_evaluators_share_their_inputs():
    T, B, hidden = 8, 6, (16,)
    cc = tsct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, hidden),
                        torch.Generator().manual_seed(2), device="cpu")
    with torch.no_grad():
        model.mu.w.mul_(30.0)
    scan = evaluate.make_evaluator(cc, B, device="cpu")(model, 11, 2)
    fused = evaluate.make_fused_evaluator(cc, B, hidden, device="cpu")(
        model, 11, 2)
    _stats_close(fused, scan)
    other = evaluate.make_evaluator(cc, B, device="cpu")(model, 12, 2)
    assert float(other["mean_return"]) != float(scan["mean_return"])
    assert float(scan["min_return"]) <= float(scan["mean_return"]) \
        <= float(scan["max_return"])


@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0"])
def test_episode_tables_are_the_stateless_rows(env_id):
    T, B, key = 6, 5, (9, 2)
    cc = tsct.make_chain(env_id, total_time_steps=T)
    dem, lt = device_episode_tables(key, cc, B, device="cpu")
    assert dem.shape == (T + 1, cc.R, cc.P, B) and dem.dtype == torch.float32
    assert torch.equal(dem, device_demand_tables(key, cc, B, device="cpu"))
    lt2 = device_leadtime_tables(key, cc, B, device="cpu")
    assert (lt is None) == (lt2 is None) == (not cc.stochastic_leadtimes)
    if lt is not None:
        assert lt.shape == (T, cc.K, B) and lt.dtype == torch.int32
        assert torch.equal(lt, lt2)
    for t in range(T + 1):
        d_row, lt_row = stateless_step_rows(key, t, cc, B, device="cpu")
        assert torch.equal(dem[t], d_row)
        if t and lt is not None:
            assert torch.equal(lt[t - 1], lt_row)


def test_episode_table_marginals():
    cc = tsct.make_chain("supplychain-ntom-v0")
    B = 1024
    dem, lt = device_episode_tables((1, 0), cc, B, device="cpu")
    cdf = poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax).astype(np.float64)
    pmf = np.diff(np.concatenate([[0.0], cdf, [1.0]]))
    hist = np.bincount(lt.numpy().ravel(), minlength=cc.Lmax + 1)[1:]
    np.testing.assert_allclose(hist / lt.numel(), pmf,
                               atol=6 * 0.5 / math.sqrt(lt.numel()))
    dh = np.bincount(dem.numpy().astype(np.int64).ravel() - 10, minlength=11)
    np.testing.assert_allclose(dh / dem.numel(), np.full(11, 1 / 11),
                               atol=6 * 0.5 / math.sqrt(dem.numel()))


# the draw's cases: (env id, chain keywords), one of each demand process
# and lead-time kind
_DRAW_CHAINS = {
    "ntom": ("supplychain-ntom-v0", {}),
    "constant-leadtimes": ("sc-2perstage-v0", {}),
    "seasonal-uniform": ("sc-2perstage-seasonal-v0",
                         dict(demand_std=10, demand_perturb_norm=False)),
    "seasonal-normal": ("sc-2perstage-seasonal-v0", {}),
    "normal": ("supplychain-oneonen-v0", dict(num_retailers=3,
                                              demand_std=10)),
    "by-product": ("sc-2perstage-multiproduct-v1",
                   dict(num_products=3, demand_std=10,
                        demand_perturb_norm=True)),
}


def _kernel_mirror(ep_key, cc, B, dtype, lane0):
    """``csrc/episode_tables.cu`` in numpy, reading the descriptor words
    (the inverse normal CDF from torch on the CPU)."""
    words = et.episode_tables_words(cc)
    T, R, P, K = et._shape(cc)
    n_cdf = len(et._thresholds(cc))
    assert len(words) == n_cdf + 8 * P + P * (T + 1)
    f32 = words.view(np.float32)
    prod = words[n_cdf:n_cdf + 8 * P].reshape(P, 8)
    base = f32[n_cdf + 8 * P:].reshape(P, T + 1)
    u = philox_uniform(ep_key, range(T + 1), K + R * P, B, "cpu",
                       lane0).numpy()
    dem = np.zeros((T + 1, R * P, B), np.float32)
    lt = np.ones((T, K, B), np.int32)
    for i in range(K):
        lt[:, i] += (u[1:, i, :, None] >= f32[None, None, :n_cdf]).sum(-1)
    for e in range(R * P):
        c, ue = prod[e % P], u[:, K + e]
        n, lo, std, mid, minv, maxv = c[1:7].view(np.float32)
        if c[0] in (0, 3):                     # uniform integers
            x = np.floor(ue * n) + lo
        else:
            z = torch.special.ndtri(torch.from_numpy(ue).double())
            x = z.float().numpy() * std
        if c[0] == 0:
            dem[:, e] = x
            continue
        x = x + mid if c[0] == 1 else base[e % P][:, None] + x
        dem[:, e] = np.rint(np.where(np.isnan(x), x, np.clip(x, minv, maxv)))
    dem = torch.from_numpy(dem.reshape(T + 1, R, P, B)).to(dtype)
    return dem, torch.from_numpy(lt) if K else None


@pytest.mark.parametrize("case", list(_DRAW_CHAINS))
def test_episode_table_descriptor_gives_the_plain_tables(case):
    env_id, kw = _DRAW_CHAINS[case]
    cc = tsct.make_chain(env_id, total_time_steps=9, **kw)
    for key, lane0, dtype in [((3, 1), 0, torch.float32),
                              ((2 ** 31 + 5, 2 ** 32 - 1), 7, torch.float64),
                              ((2 ** 32 - 1, 4), 2 ** 32 + 3,
                               torch.float32)]:
        dem, lt = episode_tables_plain(key, cc, 37, dtype, "cpu", lane0)
        dem2, lt2 = _kernel_mirror(key, cc, 37, dtype, lane0)
        assert dem.dtype == dem2.dtype and torch.equal(dem, dem2)
        assert (lt is None) == (lt2 is None)
        assert lt is None or torch.equal(lt, lt2)


def test_episode_tables_take_the_plain_path_on_the_cpu():
    cc = tsct.make_chain("supplychain-ntom-v0", total_time_steps=7)
    reset_counters()
    for dtype in (torch.float32, torch.float64):
        dem, lt = device_episode_tables((4, 2), cc, 6, dtype, "cpu", 5)
        want = episode_tables_plain((4, 2), cc, 6, dtype, "cpu", 5)
        assert torch.equal(dem, want[0]) and torch.equal(lt, want[1])
        assert dem.dtype == dtype and dem.device.type == "cpu"
    assert counters().get("launch.episode_tables", 0) == 0
    with pytest.raises(ValueError, match="CUDA"):
        et.episode_tables_descriptor(cc, "cpu")


def test_episode_table_wrapper_refuses_what_its_descriptor_does_not_hold():
    T, B = 5, 4
    cc = tsct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    desc = torch.as_tensor(et.episode_tables_words(cc), device="meta")
    meta = dict(device="meta")
    dem = torch.empty((T + 1, cc.R, cc.P, B), **meta)
    lt = torch.empty((T, cc.K, B), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="is on cpu"):
        et.launch_episode_tables(cc, desc, (1, 0),
                                 torch.empty_like(dem, device="cpu"), lt)
    with pytest.raises(ValueError, match="is on cpu"):
        et.launch_episode_tables(cc, desc, (1, 0), dem,
                                 torch.empty_like(lt, device="cpu"))
    with pytest.raises(TypeError, match="float32 or float64"):
        et.launch_episode_tables(cc, desc, (1, 0), dem.to(torch.float16), lt)
    with pytest.raises(TypeError, match="dtype"):
        et.launch_episode_tables(cc, desc, (1, 0), dem, lt.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        et.launch_episode_tables(cc, desc, (1, 0), dem[:T], lt)
    # the lead-time table's B is the demand table's
    with pytest.raises(ValueError, match="shape"):
        et.launch_episode_tables(cc, desc, (1, 0), dem, lt[..., :B - 1])
    longer = tsct.make_chain("supplychain-ntom-v0", total_time_steps=T + 1)
    with pytest.raises(ValueError, match="shape"):
        et.launch_episode_tables(longer, desc, (1, 0), dem, lt)
    with pytest.raises(ValueError, match="CUDA"):
        et.launch_episode_tables(cc, desc, (1, 0), dem, lt)
    flat = tsct.make_chain("sc-2perstage-v0", total_time_steps=T)
    with pytest.raises(ValueError, match="constant"):
        et.launch_episode_tables(
            flat, torch.as_tensor(et.episode_tables_words(flat), **meta),
            (1, 0), torch.empty((T + 1, flat.R, flat.P, B), **meta), lt)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels)")
    return torch.device("cuda")


# (chain case, B, lane0, dtype, key offset): every chain at 4096 envs, then
# lane0 != 0, a B no multiple of the kernel's 256-thread block, float64
# tables and keys with k0 >= 2**31
_CARD_DRAWS = [(case, 4096, 0, torch.float32, 0) for case in _DRAW_CHAINS] + [
    ("ntom", 4096, 3 * 4096 + 5, torch.float32, 0),
    ("ntom", 1000, 0, torch.float32, 0),
    ("by-product", 99, 17, torch.float64, 0),
    ("ntom", 4096, 0, torch.float64, 0),
    ("seasonal-normal", 777, 0, torch.float32, 2 ** 31),
    ("ntom", 4096, 2 ** 32 - 9, torch.float32, 2 ** 32 - 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,lane0,dtype,k_off", _CARD_DRAWS,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_episode_table_kernel_matches_the_plain_draw(case, B, lane0, dtype,
                                                     k_off):
    dev = _cuda()
    env_id, kw = _DRAW_CHAINS[case]
    cc = tsct.make_chain(env_id, **kw)
    reset_counters()
    for seed in range(24):
        key = (k_off + 7919 * seed, seed ^ 0x9E3779B9)
        dem, lt = device_episode_tables(key, cc, B, dtype, dev, lane0)
        assert counters()["launch.episode_tables"] == seed + 1
        want, want_lt = episode_tables_plain(key, cc, B, dtype, dev, lane0)
        assert dem.dtype == dtype and dem.is_cuda
        assert torch.equal(dem, want), (seed, (dem != want).sum().item())
        assert ((lt is None) == (want_lt is None)
                == (not cc.stochastic_leadtimes))
        assert lt is None or torch.equal(lt, want_lt), seed


@pytest.mark.cuda
def test_episode_table_kernel_covers_any_horizon():
    # more periods than a grid's y axis holds (65535)
    dev = _cuda()
    cc = tsct.make_chain("supplychain-ntom-v0", total_time_steps=70000)
    for seed in range(3):
        key = (2 ** 31 + seed, seed)
        dem, lt = device_episode_tables(key, cc, 37, torch.float32, dev, 5)
        want, want_lt = episode_tables_plain(key, cc, 37, torch.float32, dev,
                                             5)
        assert torch.equal(dem, want) and torch.equal(lt, want_lt), seed


@pytest.mark.parametrize("env_id", ["supplychain-ntom-v0",
                                    "supplychain-2perstage-v0",
                                    "supplychain-linear-v0"])
def test_base_stock_policy_matches_jax(env_id):
    import jax.numpy as jnp
    import gym_supplychain_tpu as jsct
    from gym_supplychain_tpu.core.step import (
        make_supplychain_kernels as jax_kernels)
    from gym_supplychain_tpu.learn import heuristics as jheur

    T, B = 10, 6
    cc = jsct.make(env_id, total_time_steps=T).cc
    rs = np.random.RandomState(1)
    j_reset, j_step, _ = jax_kernels(cc, dtype=jnp.float32)
    dem = rs.randint(0, 30, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    lt = rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B)).astype(np.int32)
    jst = j_reset(dem, lt, B)
    for t in range(4):
        jst, _ = j_step(jst, jnp.asarray(2 * rs.rand(cc.A, B) - 1,
                                         jnp.float32))
    tst = state_from_numpy({k: None if v is None else np.asarray(v)
                            for k, v in jst._asdict().items()}, device="cpu")
    np.testing.assert_array_equal(heuristics.mean_demand(cc),
                                  jheur.mean_demand(cc))
    for z in (0.5, 1.5, 3.0):
        tgt = heuristics.default_base_stock_targets(cc, z)
        np.testing.assert_array_equal(tgt,
                                      jheur.default_base_stock_targets(cc, z))
        want = np.asarray(jheur.make_base_stock_policy(cc, tgt)(jst))
        got = heuristics.make_base_stock_policy(cc, tgt)(tst)
        assert got.dtype == torch.float32 and got.shape == (cc.A, B)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_best_base_stock_grid():
    cc = tsct.make_chain("sc-2perstage-v0", total_time_steps=6)
    z, best, scores = heuristics.best_base_stock(cc, 4, 3, zs=(0.5, 2.0),
                                                 episodes=2, device="cpu")
    assert set(scores) == {0.5, 2.0} and best == max(scores.values())
    assert scores[z] == best and all(math.isfinite(v) for v in scores.values())
    again = heuristics.evaluate_state_policy(
        cc, 4, heuristics.default_base_stock_targets(cc, z), 3, episodes=2,
        device="cpu")
    assert again == best


def test_train_then_evaluate_cli_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train.main(["--envs", "4", "--hidden", "8", "--horizon", "6",
                "--rollout-steps", "3", "--iters", "2", "--log-every", "1",
                "--device", "cpu", "--checkpoint-dir", ck])
    assert "# checkpoint:" in capsys.readouterr().out
    got = {}
    for engine in ("kernel", "scan"):
        got[engine] = evaluate.main(["--restore", ck, "--envs", "5",
                                     "--horizon", "7", "--episodes", "2",
                                     "--engine", engine, "--device", "cpu"])
        assert set(got[engine]) == {"mean_return", "std_return",
                                    "min_return", "max_return"}
    _stats_close(got["kernel"], got["scan"])
    with pytest.raises(SystemExit, match="trunk"):
        evaluate.main(["--restore", ck, "--hidden", "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="make_beergame_evaluator"):
        evaluate.main(["--restore", ck, "--env", "beergame-v0",
                       "--device", "cpu"])


def test_compare_baseline_cli_prints_its_report(capsys):
    report = compare_baseline.main([
        "--horizon", "5", "--envs", "4", "--iters", "2", "--rollout", "3",
        "--epochs", "1", "--hidden", "8", "--eval-episodes", "1",
        "--zs", "0.5", "1.0", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == report
    assert set(report) == {"env", "horizon", "envs", "base_stock", "ppo",
                           "ppo_beats_base_stock_by"}
    assert set(report["base_stock"]) == {"best_z", "mean_return", "grid",
                                         "grid_seconds"}
    assert len(report["ppo"]["curve"]) == 2


@pytest.mark.parametrize("cli,argv", [
    (train, []), (evaluate, ["--restore", "ck"]), (compare_baseline, [])])
def test_clis_stop_without_a_card(cli, argv, monkeypatch):
    """``--device cuda`` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(argv)


def _constructors():
    import gym_supplychain_tpu_torch as sct
    from gym_supplychain_tpu_torch.core import beergame, step
    from gym_supplychain_tpu_torch.envs import gym_registry, vector
    from gym_supplychain_tpu_torch.learn import ppo
    from gym_supplychain_tpu_torch.models import policy
    from gym_supplychain_tpu_torch.ops import (beergame_collect,
                                               supplychain_collect,
                                               supplychain_episode)
    from gym_supplychain_tpu_torch.rng import device

    return [supplychain_collect.make_supplychain_collect,
            beergame_collect.make_beergame_collect, ppo.make_ppo,
            ppo.make_ppo_fused, policy.ActorCritic, policy.params_from_jax,
            vector.make_vec_env, vector.VecSupplyChainEnv,
            vector.make_beergame_table_draw, vector.VecBeerGameEnv,
            step.make_supplychain_kernels, step.state_from_numpy,
            beergame.make_beergame_kernels, device.stateless_step_rows,
            device.device_episode_tables, device.device_demand_tables,
            device.device_leadtime_tables,
            supplychain_episode.make_supplychain_episode,
            supplychain_episode.make_supplychain_policy_rollout,
            evaluate.make_evaluator, evaluate.make_fused_evaluator,
            heuristics.evaluate_state_policy, heuristics.best_base_stock,
            ppo.make_beergame_ppo, policy.DiscreteActorCritic,
            policy.discrete_params_from_jax, vector.beergame_table_config,
            evaluate.make_beergame_evaluator,
            heuristics.beergame_base_stock_runner,
            heuristics.best_beergame_base_stock, sct.SupplyChainEnv,
            sct.SupplyChainNtoMEnv, sct.BeerGameEnv, sct.BeerGameEnv2,
            gym_registry.GymnasiumVectorAdapter]


@pytest.mark.parametrize("fn", _constructors(), ids=lambda f: f.__name__)
def test_public_constructors_default_to_the_card(fn):
    default = inspect.signature(fn).parameters["device"].default
    assert default == "cuda", (fn.__qualname__, default)
