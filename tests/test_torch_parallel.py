"""Data-parallel training over processes in the port (``parallel/mesh.py``,
the ``mesh=`` trainers, multi-process checkpoints, the train CLI's
``--multihost`` and ``--trace-dir``), on the CPU over gloo.

Two OS processes, as ``tests/test_multihost.py`` spawns them
(``tests/torch_parallel_worker.py``, once for the module, each with a
deadline), run the trainers at B = 16, T = 6, hidden (16, 16): their first
iteration equals the 1-process run at the same global B within 1e-4 x
max(1, |value|) (the ranks average two halves' sums where one process sums
the whole), and their parameters are bit-equal after 3 iterations.  The
mesh form of the update holds against the JAX ``_make_update`` on the
same data at ``test_update_matches_optax``'s tolerance.  The per-lane
Philox streams with ``lane0`` are checked in process against the unsharded
draws, bit for bit.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_supplychain_tpu.learn import ppo as jppo
from gym_supplychain_tpu.models.policy import MLPConfig as JMLPConfig
from gym_supplychain_tpu.models.policy import actor_critic_forward as j_forward
from gym_supplychain_tpu.models.policy import init_actor_critic
from gym_supplychain_tpu.models.policy import tanh_gaussian_logp as j_logp

import gym_supplychain_tpu_torch as sct
from gym_supplychain_tpu_torch.envs.vector import make_vec_env
from gym_supplychain_tpu_torch.learn import ppo, train
from gym_supplychain_tpu_torch.ops.supplychain_collect import (
    make_supplychain_collect, philox_tables)
from gym_supplychain_tpu_torch.parallel import mesh as pm
from gym_supplychain_tpu_torch.rng.device import (device_episode_tables,
                                                  philox_uniform,
                                                  stateless_step_rows)
from gym_supplychain_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                        save_checkpoint)
from gym_supplychain_tpu_torch.utils.profiling import kernel_busy_share

_WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
B, T, HIDDEN = 16, 6, (16, 16)
TOL = 1e-4                     # x max(1, |value|): 2 ranks against 1 process
UPD = dict(O=9, A=5, hidden=(16, 16), S=8, B=16)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trainer(kind, noise, mesh=None):
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    cfg = ppo.PPOConfig(rollout_steps=T, epochs=2, hidden=HIDDEN)
    if kind == "fused":
        return ppo.make_ppo_fused(cc, B, cfg, noise=noise, device="cpu",
                                  mesh=mesh)
    return ppo.make_ppo(cc, B, cfg, device="cpu", mesh=mesh)


def _flat(state):
    return torch.cat([p.detach().reshape(-1) for p in state.params.flat()])


def _update_inputs():
    """The JAX tree and update data of ``test_update_matches_optax``'s kind
    (both ratio clips live), as numpy."""
    O, A, hidden, S, Bu = (UPD[k] for k in ("O", "A", "hidden", "S", "B"))
    M = S * Bu
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        init_actor_critic(jax.random.PRNGKey(2),
                                          JMLPConfig(O, A, hidden),
                                          jnp.float32))
    rs = np.random.RandomState(2)
    obs = rs.uniform(-1, 1, size=(O, M)).astype(np.float32)
    mu, log_std, _ = j_forward(tree, jnp.asarray(obs))
    pre = (np.asarray(mu) + np.exp(np.asarray(log_std))
           * rs.randn(A, M)).astype(np.float32)
    old = (np.asarray(j_logp(jnp.asarray(pre), mu, log_std))
           + 0.3 * rs.randn(M)).astype(np.float32)
    adv = rs.randn(M).astype(np.float32)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    ret = rs.randn(M).astype(np.float32)
    # [X, M] time-major -> the sample-last [X, S, B] update layout
    data = dict(obs=obs.reshape(O, S, Bu), pre=pre.reshape(A, S, Bu),
                old=old.reshape(S, Bu), adv=adv.reshape(S, Bu),
                ret=ret.reshape(S, Bu))
    return tree, data


def _leaves(tree):
    flat = []
    for layer in tree["actor"]:
        flat += [layer["w"], layer["b"]]
    flat += [tree["mu"]["w"], tree["mu"]["b"]]
    for layer in tree["critic"]:
        flat += [layer["w"], layer["b"]]
    return flat + [tree["v"]["w"], tree["v"]["b"], tree["log_std"]]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the worker on 2 ranks once; returns (out dir, results, arrays)
    a rank, and what the launcher wrote for it."""
    out = tmp_path_factory.mktemp("ranks")
    tree, data = _update_inputs()
    np.savez(out / "update_data.npz", hidden=np.asarray(UPD["hidden"]),
             **data, **{f"leaf{i}": x for i, x in enumerate(_leaves(tree))})
    # a 1-process checkpoint for the ranks to restore
    init_fn, step = _trainer("scan", None)
    state = init_fn(0)
    for _ in range(2):
        state, _ = step(state)
    save_checkpoint(str(out / "ck1"), state, step=2)
    # (the step updates the parameters in place)
    ck1 = dict(params=_flat(state).clone(), env={
        k: v.clone() for k, v in state.env.env._asdict().items()
        if isinstance(v, torch.Tensor)})
    _, ck1["next"] = step(state)
    port, cli_port = _free_port(), _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, str(out), str(cli_port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{so}\n{se[-3000:]}"
            outs.append(so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = [json.load(open(out / f"rank{r}.json")) for r in range(2)]
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    return dict(out=out, res=res, arrays=arrays, stdout=outs, tree=tree,
                data=data, ck1=ck1)


@pytest.mark.parametrize("case", ["fused-prng", "fused-table", "scan"])
def test_two_ranks_match_one_process(two_ranks, case):
    """The 2-rank first iteration (each rank 8 of the 16 lanes) against one
    process at B = 16: loss, mean reward and mean value."""
    kind, noise = {"fused-prng": ("fused", "prng"),
                   "fused-table": ("fused", "table"),
                   "scan": ("scan", None)}[case]
    init_fn, step = _trainer(kind, noise)
    _, want = step(init_fn(0))
    for r in range(2):
        got = two_ranks["res"][r][case]["metrics"][0]
        for k in ("loss", "mean_reward", "mean_value"):
            w = float(want[k])
            assert abs(got[k] - w) <= TOL * max(1.0, abs(w)), (case, r, k)


@pytest.mark.parametrize("case", ["fused-prng", "fused-table", "scan"])
def test_ranks_parameters_bit_equal(two_ranks, case):
    """After 3 iterations both ranks hold the same parameter bits, and the
    mesh's ``replicated`` check says so on each rank."""
    a, b = (two_ranks["arrays"][r][f"{case}.params"] for r in range(2))
    assert a.tobytes() == b.tobytes()
    assert all(two_ranks["res"][r][case]["replicated"] for r in range(2))
    # the metrics each rank reports are the same global means
    m0, m1 = (two_ranks["res"][r][case]["metrics"] for r in range(2))
    assert m0 == m1


@pytest.mark.parametrize("epochs", [1, 2])
def test_data_exchange_is_counted(two_ranks, epochs):
    """One fused iteration all-reduces over the data group twice for the
    advantages' normalization, once an epoch for the packed gradients and
    loss, and once for the metrics; ``collective.data_bytes`` is what each
    rank handed those all-reduces (float32)."""
    for r in range(2):
        ex = two_ranks["res"][r][f"exchange{epochs}"]
        grads = 4 * (ex["params"] + 1)        # the leaves and the loss
        assert ex["counters"] == {
            "collective.data": 2 + epochs + 1,
            "collective.data_bytes": 2 * 4 + epochs * grads + 2 * 4}


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("parent,calls", [("ppo.normalize", lambda e: 2),
                                          ("ppo.grads", lambda e: e),
                                          (None, lambda e: 1)])
def test_data_all_reduce_spans(two_ranks, epochs, parent, calls):
    """With the spans on, each all-reduce over the data group runs in a
    ``mesh.data_all_reduce`` span under the trainer's span that called it:
    the normalization's two, a step's gradients, the metrics' outside any
    span."""
    for r in range(2):
        parents = two_ranks["res"][r][f"exchange{epochs}"]["parents"]
        assert parents.count(parent) == calls(epochs)


@pytest.mark.parametrize("one", ["no mesh", "a mesh of one process"])
def test_one_process_counts_no_exchange(one):
    """Without a data axis the trainer counts no collective and opens no
    ``mesh.*`` span."""
    from gym_supplychain_tpu_torch.utils import profiling

    mesh = None if one == "no mesh" else pm.make_mesh(device="cpu")
    init_fn, step = _trainer("fused", "prng", mesh)
    state = init_fn(0)
    profiling.reset_counters()
    profiling.take()
    was = profiling.enable(True)
    try:
        step(state)
    finally:
        profiling.enable(was)
    names = {s.name for s in profiling.take()}
    assert "ppo.normalize" in names and "ppo.grads" in names
    assert not {n for n in names if n.startswith("mesh.")}
    assert not {k for k in profiling.counters() if k.startswith("collective.")}


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_update_matches_jax(two_ranks, fused):
    """Each rank's update over its 8 of 16 lanes, the loss and gradients
    averaged in one all-reduce a step, against the JAX ``_make_update`` on
    the whole data (``test_update_matches_optax``'s tolerance)."""
    tree, data = two_ranks["tree"], two_ranks["data"]
    jcfg = jppo.PPOConfig(hidden=UPD["hidden"], epochs=2, lr=1e-3,
                          max_grad_norm=0.05)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     optax.adam(jcfg.lr))
    jtree = jax.tree.map(jnp.asarray, tree)
    want, _, want_losses = jppo._make_update(
        jcfg, tx, jppo._make_cont_loss(jcfg))(
            jtree, tx.init(jtree),
            tuple(jnp.asarray(data[k]) for k in ("obs", "pre", "old", "adv",
                                                 "ret")))
    want = _leaves(jax.tree.map(np.asarray, want))
    for r in range(2):
        arr = two_ranks["arrays"][r]
        np.testing.assert_allclose(arr[f"update{int(fused)}.losses"],
                                   np.asarray(want_losses), rtol=1e-5,
                                   atol=1e-6)
        for i, w in enumerate(want):
            np.testing.assert_allclose(arr[f"update{int(fused)}.leaf{i}"],
                                       w, rtol=0, atol=2e-3 * jcfg.lr)


def test_two_rank_checkpoint_resumes_bit_exact(two_ranks):
    """A checkpoint the 2 ranks wrote, restored by the same ranks into
    fresh states, repeats the uninterrupted iteration bit for bit."""
    assert all(two_ranks["res"][r]["resume_bit_exact"] for r in range(2))


def test_two_rank_checkpoint_loads_into_one_process(two_ranks):
    """The file the 2 ranks wrote is the 1-process file: the parameters as
    saved, the env lanes in global order; its next iteration in one
    process agrees with the ranks' within the tolerance."""
    init_fn, step = _trainer("scan", None)
    state = restore_checkpoint(str(two_ranks["out"] / "ck2"),
                               like=init_fn(1))
    a0, a1 = two_ranks["arrays"]
    assert _flat(state).numpy().tobytes() == a0["saved.params"].tobytes()
    for k, v in state.env.env._asdict().items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(
                v.numpy(), np.concatenate([a0[f"saved.{k}"],
                                           a1[f"saved.{k}"]], axis=-1))
    _, m = step(state)
    want = two_ranks["res"][0]["after_save"]
    for k in ("loss", "mean_reward", "mean_value"):
        assert abs(float(m[k]) - want[k]) <= TOL * max(1.0, abs(want[k])), k


def test_one_process_checkpoint_loads_into_two_ranks(two_ranks):
    """A 1-process file restored into 2 ranks: each rank's lanes are its
    slice of the global env, the parameters are whole; the ranks' next
    iteration agrees with the 1-process one within the tolerance."""
    ck1 = two_ranks["ck1"]
    for r in range(2):
        arr = two_ranks["arrays"][r]
        assert arr["from1.params"].tobytes() == ck1["params"].numpy().tobytes()
        for k, v in ck1["env"].items():
            np.testing.assert_array_equal(
                arr[f"from1.{k}"], v.numpy()[..., r * B // 2:(r + 1) * B // 2])
    got = two_ranks["res"][0]["from1_next"]
    for k in ("loss", "mean_reward", "mean_value"):
        w = float(ck1["next"][k])
        assert abs(got[k] - w) <= TOL * max(1.0, abs(w)), k


def test_train_cli_multihost_on_the_cpu(two_ranks):
    """``--multihost --trace-dir --checkpoint-dir`` over 2 gloo ranks: rank
    0 alone logs (the engine line names gloo and 2 ranks) and writes the
    checkpoint; every rank writes its trace."""
    out = two_ranks["out"]
    lead, other = two_ranks["stdout"]
    assert "backend=gloo world=2" in lead and '"env_steps_per_s"' in lead
    assert "# engine" not in other and "env_steps_per_s" not in other
    assert os.path.isfile(out / "ck_cli" / "step_2.pt")
    for r in range(2):
        assert np.isfinite(two_ranks["res"][r]["cli_loss"])
        busy = kernel_busy_share(str(out / "trace" / f"trace.rank{r}.json"))
        assert busy["window_ms"] > 0 and busy["kernels"] == 0   # the CPU


def test_train_cli_trace_dir_on_the_cpu(tmp_path, capsys):
    """``--trace-dir`` in one process: a Chrome trace of the loop."""
    train.main(["--envs", "4", "--hidden", "8", "--horizon", "6",
                "--rollout-steps", "4", "--iters", "2", "--device", "cpu",
                "--trace-dir", str(tmp_path / "tr")])
    assert "# trace:" in capsys.readouterr().out
    with open(tmp_path / "tr" / "trace.rank0.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "1"},
                                 {"WORLD_SIZE": "2", "RANK": "0"}])
def test_train_cli_multihost_without_a_group_stops(monkeypatch, env):
    """``--multihost`` never trains alone: no group of two or more
    processes (or no coordinator to reach it) stops with an error."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="--multihost"):
        train.main(["--multihost", "--iters", "1", "--device", "cpu"])


def test_mesh_refuses_tensor_parallelism_and_uneven_shards():
    """One process holds no model axis (a world of 1 is no ``1x2`` mesh);
    the data axis refuses uneven shards, and a rank's lanes are its data
    index's (``tests/test_torch_tensor_parallel.py`` runs the model
    axis)."""
    with pytest.raises(ValueError, match="1x2 != 1 processes"):
        pm.make_mesh(model=2, device="cpu")
    mesh = pm.make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.data) == (1, 0, 1)
    assert pm.lane_range(mesh, 16) == (0, 16) == pm.lane_range(None, 16)
    assert pm.replicated(mesh, torch.ones(3))
    two = pm.Mesh(data=2, model=1, rank=1, world=2,
                  device=torch.device("cpu"), backend="gloo")
    assert pm.lane_range(two, 16) == (8, 16)
    two_by_two = pm.Mesh(data=2, model=2, rank=3, world=4,
                         device=torch.device("cpu"), backend="gloo")
    assert (two_by_two.data_index, two_by_two.model_index) == (1, 1)
    assert pm.lane_range(two_by_two, 16) == (8, 16)
    with pytest.raises(ValueError, match="divisible"):
        pm.lane_range(two, 15)
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    with pytest.raises(ValueError, match="minibatches"):
        ppo.make_ppo_fused(cc, 12, ppo.PPOConfig(hidden=(8,), minibatches=4),
                           mesh=two)
    with pytest.raises(ValueError, match="minibatches"):
        ppo.make_ppo(cc, 12, ppo.PPOConfig(hidden=(8,), minibatches=4),
                     mesh=two)


def _halves(fn):
    """fn(B, lane0) of the whole batch against its two halves."""
    full = fn(B, 0)
    parts = [fn(B // 2, lo) for lo in (0, B // 2)]
    return full, parts


@pytest.mark.parametrize("env_id", ["supplychain-ntom-v0",
                                    "sc-2perstage-seasonal-v0"])
def test_lane0_slices_equal_the_unsharded_draws(env_id):
    """With ``lane0`` a slice of lanes draws, bit for bit, what those lanes
    draw in the whole batch: ``philox_uniform``, ``philox_tables`` (both
    kinds), ``stateless_step_rows``, ``device_episode_tables`` and the
    plain ``policy`` collection's draws; ``lane0 = 0`` is the old stream."""
    cc = sct.make_chain(env_id, total_time_steps=T)
    checks = {
        "philox_uniform": lambda n, lo: (philox_uniform(
            (5, 7), range(3), 6, n, "cpu", lane0=lo),),
        "philox_tables": lambda n, lo: philox_tables(
            cc, 9, range(2 * T), n, "cpu", lane0=lo),
        "philox_tables policy": lambda n, lo: philox_tables(
            cc, 9, range(2 * T), n, "cpu", policy=True, lane0=lo),
        "stateless_step_rows": lambda n, lo: stateless_step_rows(
            (3, 1), 2, cc, n, device="cpu", lane0=lo),
        "device_episode_tables": lambda n, lo: device_episode_tables(
            (3, 1), cc, n, device="cpu", lane0=lo),
    }
    for name, fn in checks.items():
        full, parts = _halves(fn)
        for f, a, b in zip(full, *parts):
            if f is None:
                continue
            assert torch.equal(f, torch.cat([a, b], dim=-1)), name
    # lane0 = 0 is the stream the port drew before it had the argument
    assert torch.equal(philox_uniform((5, 7), range(3), 6, B, "cpu"),
                       checks["philox_uniform"](B, 0)[0])
    model = ppo.ActorCritic(ppo.MLPConfig(cc.obs_dim, cc.A, (8,)),
                            torch.Generator().manual_seed(0), "cpu")
    full, parts = _halves(lambda n, lo: make_supplychain_collect(
        cc, T, n, mode="policy", device="cpu", hidden=(8,), lane0=lo)(
            model, 11))
    # obs, actions, log-probs and values bit for bit; the plain reward
    # sums its cost terms in an order the batch width may change
    for i, (f, a, b) in enumerate(zip(full, *parts)):
        cat = torch.cat([a, b], dim=-1)
        if i < 4:
            assert torch.equal(f, cat), i
        else:
            torch.testing.assert_close(f, cat, rtol=1e-6, atol=0)


def test_vec_env_lane0_plays_the_global_lanes():
    """The scan trainer's env: ``make_vec_env(lane0=...)`` on a slice plays
    the global env's lanes (the demand rows bit for bit, the stock to the
    float rules' rounding)."""
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    g = torch.Generator().manual_seed(3)
    acts = [torch.rand((cc.A, B), generator=g) * 2 - 1 for _ in range(T + 2)]
    runs = []
    for n, lo in ((B, 0), (B // 2, 0), (B // 2, B // 2)):
        init, step, obs = make_vec_env(cc, n, device="cpu", lane0=lo)
        st = init(4)
        for a in acts:
            st, _ = step(st, a[:, lo:lo + n])
        runs.append(st.env)
    full, a, b = runs
    assert torch.equal(full.demands, torch.cat([a.demands, b.demands], -1))
    torch.testing.assert_close(full.stock, torch.cat([a.stock, b.stock], -1),
                               rtol=1e-6, atol=1e-6)


def test_kernel_busy_share_is_the_union_of_kernel_intervals(tmp_path):
    """Overlapping kernels count once; host events set the window."""
    events = [dict(ph="X", cat="cpu_op", ts=0.0, dur=100.0),
              dict(ph="X", cat="kernel", ts=10.0, dur=20.0),
              dict(ph="X", cat="kernel", ts=20.0, dur=20.0),
              dict(ph="X", cat="kernel", ts=60.0, dur=10.0),
              dict(ph="i", cat="kernel", ts=80.0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy = kernel_busy_share(str(path))
    assert busy["kernels"] == 3
    assert busy["busy_ms"] == pytest.approx(0.040)
    assert busy["window_ms"] == pytest.approx(0.100)
    assert busy["share"] == pytest.approx(0.4)


def test_multihost_scaling_benchmark_on_the_cpu():
    """The scaling benchmark's launcher: 1 process, then 2 ranks spawned
    under a deadline, one result each; the 2-rank first iteration agrees
    with 1 process's, the ranks' parameters are bit-equal, a checkpoint
    they wrote resumes bit for bit, and the all-reduce is counted."""
    from gym_supplychain_tpu_torch.benchmarks import multihost_scaling

    r1, r2 = multihost_scaling.run(((1, 1), (2, 1)), envs=B, horizon=T,
                                   hidden=HIDDEN, iters=2, device="cpu",
                                   timeout=240)
    assert (r1["processes"], r2["processes"]) == (1, 2)
    assert (r2["backend"], r2["lanes_per_rank"]) == ("gloo", B // 2)
    for k, w in r1["first"].items():
        assert abs(r2["first"][k] - w) <= TOL * max(1.0, abs(w)), k
    assert r1["resume_bit_exact"] and r2["resume_bit_exact"]
    assert r2["replicated"]
    # two epochs of one minibatch, the advantages' two passes, the metrics
    assert r2["allreduce_calls_per_iter"] == 5
    assert r1["allreduce_ms_per_iter"] == 0.0 < r2["allreduce_ms_per_iter"]
    assert r2["train_env_steps_per_s"] > 0
