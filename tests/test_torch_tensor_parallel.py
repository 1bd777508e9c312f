"""Tensor parallelism over the mesh's model axis in the port
(``parallel/mesh.py``'s two-axis mesh, ``models/policy.py``'s sharded
trunks, the trainers, checkpoints and the train CLI with ``--model-axis``),
on the CPU over gloo.

Four OS processes (``tests/torch_tensor_parallel_worker.py``, spawned once
for the module under a deadline) build ``2x2``, ``4x1`` and ``1x4`` meshes
over one world.  The tensor-parallel forwards hold against the JAX
package's at 1e-6 of each output's largest value; the tensor-parallel
update (autograd, and the update kernel's plain version on the gathered
net) against the JAX ``_make_update`` on the whole data at
``test_mesh_update_matches_jax``'s tolerance, with the clip active
(``max_grad_norm=0.05``); the trainers' first iteration against one
process at the same global batch within 1e-4 x max(1, |value|); the
replicated leaves bit-equal on every rank after 3 iterations; checkpoints
moved between 1 process and ``2x2`` bit for bit.
"""
import json
import os
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
from gym_supplychain_tpu.models.policy import discrete_forward as j_discrete
from gym_supplychain_tpu.models.policy import (init_actor_critic,
                                               init_discrete_actor_critic)

import gym_supplychain_tpu_torch as sct
from gym_supplychain_tpu_torch.envs.vector import make_beergame_table_draw
from gym_supplychain_tpu_torch.learn import ppo
from gym_supplychain_tpu_torch.models import policy
from gym_supplychain_tpu_torch.parallel import mesh as pm
from gym_supplychain_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                        save_checkpoint)

from .test_torch_parallel import UPD, _free_port, _leaves, _update_inputs

_WORKER = os.path.join(os.path.dirname(__file__),
                       "torch_tensor_parallel_worker.py")
WORLD = 4
B, T, HIDDEN = 16, 6, (16, 16)
TOL = 1e-4                     # x max(1, |value|): ranks against 1 process
FWD_TOL = 1e-6                 # x max |output|: the forwards against JAX
N_CHOICES = 16                 # the beer game's order quantities
BG = dict(v2=True, customer_demand=(0, 12), shipment_delays=(0, 4))
CASES = ["2x2-scan", "2x2-beergame", "2x2-fused", "4x1-scan",
         "4x1-beergame", "1x4-scan"]


def _trainer(kind):
    cfg = ppo.PPOConfig(rollout_steps=T, epochs=2, hidden=HIDDEN)
    if kind == "beergame":
        return ppo.make_beergame_ppo(B, cfg, device="cpu", **BG)
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    if kind == "fused":
        return ppo.make_ppo_fused(cc, B, cfg, device="cpu")
    return ppo.make_ppo(cc, B, cfg, device="cpu")


def _flat(params):
    return torch.cat([p.detach().reshape(-1) for p in params.flat()])


def _npz_tree(prefix, tree):
    """A JAX parameter tree as flat npz entries ``prefix.actor.0.w``."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, list):
            for i, layer in enumerate(node):
                for leaf, x in layer.items():
                    out[f"{prefix}.{key}.{i}.{leaf}"] = np.asarray(x)
        elif isinstance(node, dict):
            for leaf, x in node.items():
                out[f"{prefix}.{key}.{leaf}"] = np.asarray(x)
        else:
            out[f"{prefix}.{key}"] = np.asarray(node)
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Run the worker on 4 ranks once; returns (out dir, results, arrays)
    a rank, and what the launcher wrote for them."""
    out = tmp_path_factory.mktemp("tp_ranks")
    rs = np.random.RandomState(5)
    ac = init_actor_critic(jax.random.PRNGKey(0), JMLPConfig(9, 5, HIDDEN))
    dac = init_discrete_actor_critic(jax.random.PRNGKey(1),
                                     JMLPConfig(4, 4, HIDDEN), N_CHOICES)
    upd_tree, data = _update_inputs()
    inputs = dict(obs_ac=rs.uniform(-1, 1, (9, 32)).astype(np.float32),
                  obs_dac=rs.uniform(-1, 1, (4, 32)).astype(np.float32),
                  n_choices=np.asarray(N_CHOICES),
                  **_npz_tree("ac", ac), **_npz_tree("dac", dac),
                  **_npz_tree("upd", upd_tree),
                  **{f"upd.{k}": v for k, v in data.items()})
    np.savez(out / "inputs.npz", **inputs)
    # 1-process checkpoints for the ranks to restore
    for kind in ("scan", "beergame", "fused"):
        init_fn, step = _trainer(kind)
        state = init_fn(0)
        for _ in range(2):
            state, _ = step(state)
        save_checkpoint(str(out / f"ck1_{kind}"), state, step=2)
    port, cli_port, bg_port = _free_port(), _free_port(), _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, str(out), str(cli_port), str(bg_port)],
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
    res = [json.load(open(out / f"rank{r}.json")) for r in range(WORLD)]
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(out=out, res=res, arrays=arrays, stdout=outs, ac=ac,
                dac=dac, inputs=inputs, upd_tree=upd_tree, data=data)


def _close(got, want, tol=FWD_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("net", ["actor-critic", "discrete"])
def test_tensor_parallel_forward_matches_jax(four_ranks, mesh, net):
    """Each rank's tensor-parallel forward (its rows of every trunk layer,
    the activations gathered) against the JAX forward of the whole net."""
    inp = four_ranks["inputs"]
    if net == "actor-critic":
        want = dict(zip(("mu", "log_std", "v"), j_forward(
            four_ranks["ac"], jnp.asarray(inp["obs_ac"]))))
        tag = "ac"
    else:
        want = dict(zip(("logits", "v"), j_discrete(
            four_ranks["dac"], jnp.asarray(inp["obs_dac"]), 4, N_CHOICES)))
        tag = "dac"
    for r in range(WORLD):
        for k, w in want.items():
            _close(four_ranks["arrays"][r][f"{mesh}.fwd.{tag}.{k}"], w)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_tensor_parallel_bf16_forward_matches_one_process(four_ranks, mesh):
    """The bf16 trunks sharded: each rank's forward against the port's
    1-process bf16 forward of the same weights, at float32 precision (each
    row is the same bf16 product; only the gather lies between)."""
    for r in range(WORLD):
        arr = four_ranks["arrays"][r]
        for k in ("mu", "log_std", "v"):
            _close(arr[f"{mesh}.fwd.ac_bf16.{k}"],
                   arr[f"{mesh}.fwd.ac_bf16_one.{k}"])


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("fused", [False, True])
def test_tensor_parallel_update_matches_jax(four_ranks, mesh, fused):
    """The update with the trunks split over the model axis (autograd
    through the gathers, or the update kernel's plain version on the
    gathered net), each data shard on its lanes, against the JAX
    ``_make_update`` on the whole data, the clip active."""
    tree, data = four_ranks["upd_tree"], four_ranks["data"]
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
    for r in range(WORLD):
        arr = four_ranks["arrays"][r]
        np.testing.assert_allclose(arr[f"{mesh}.update{int(fused)}.losses"],
                                   np.asarray(want_losses), rtol=1e-5,
                                   atol=1e-6)
        for i, w in enumerate(want):
            np.testing.assert_allclose(
                arr[f"{mesh}.update{int(fused)}.leaf{i}"], w, rtol=0,
                atol=2e-3 * jcfg.lr)


@pytest.mark.parametrize("case", CASES)
def test_trainers_match_one_process(four_ranks, case):
    """The first iteration over the mesh (the rank's data shard of the 16
    lanes; a model axis splitting the trunks, or holding the fused
    trainer's parameters whole) against one process at B = 16."""
    mesh, kind = case.split("-")
    init_fn, step = _trainer(kind)
    _, want = step(init_fn(0))
    for r in range(WORLD):
        got = four_ranks["res"][r][f"{mesh}.{kind}"]["metrics"][0]
        for k in ("loss", "mean_reward", "mean_value"):
            w = float(want[k])
            assert abs(got[k] - w) <= TOL * max(1.0, abs(w)), (case, r, k)


@pytest.mark.parametrize("case", CASES)
def test_ranks_stay_replicated(four_ranks, case):
    """After 3 iterations every rank holds the same bits of the replicated
    leaves (heads, ``log_std``; every leaf of the fused trainer) and the
    same gathered net, the mesh's ``replicated`` check agrees on each rank,
    and every rank reports the same metrics."""
    mesh, kind = case.split("-")
    arrays = four_ranks["arrays"]
    for key in (f"{mesh}.{kind}.replicated", f"{mesh}.{kind}.params"):
        assert len({a[key].tobytes() for a in arrays}) == 1, key
    res = [r[f"{mesh}.{kind}"] for r in four_ranks["res"]]
    assert all(r["replicated_leaves"] and r["gathered_trunk"] for r in res)
    assert all(r["metrics"] == res[0]["metrics"] for r in res)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_beergame_ranks_draw_the_global_tables(four_ranks, mesh):
    """Each rank's first episode tables are its data shard's lanes of the
    1-process draw, bit for bit."""
    init_fn, _ = _trainer("beergame")
    env = init_fn(0).env.env
    data = {"2x2": 2, "4x1": 4}[mesh]
    for r in range(WORLD):
        d = r // (WORLD // data)
        n = B // data
        for k in ("customer_demand", "shipment_delays"):
            np.testing.assert_array_equal(
                four_ranks["arrays"][r][f"{mesh}.beergame.{k}"],
                getattr(env, k).numpy()[..., d * n:(d + 1) * n])


@pytest.mark.parametrize("kind", ["scan", "beergame", "fused"])
def test_checkpoint_from_one_process_gives_each_rank_its_rows(four_ranks,
                                                              kind):
    """A 1-process file restored into ``2x2``: each rank's trunk rows and
    their Adam moments are its slice of the file's, bit for bit (the whole
    of them for the fused trainer, which keeps its parameters whole)."""
    for res in four_ranks["res"]:
        assert res[f"ck.{kind}.from1_rows"]
        assert res[f"ck.{kind}.from1_moments"]


@pytest.mark.parametrize("kind", ["scan", "beergame", "fused"])
def test_checkpoint_resumes_and_round_trips_bit_exact(four_ranks, kind):
    """A ``2x2`` checkpoint resumed by ``2x2`` repeats the uninterrupted
    iteration bit for bit, and so does the same file after one process
    restored and wrote it again (``2x2`` -> 1 process -> ``2x2``)."""
    for res in four_ranks["res"]:
        assert res[f"ck.{kind}.resume_bit_exact"]
        assert res[f"ck.{kind}.round_trip_bit_exact"]


@pytest.mark.parametrize("kind", ["scan", "beergame", "fused"])
def test_checkpoint_of_2x2_loads_into_one_process(four_ranks, kind):
    """The file ``2x2`` wrote holds the global parameters (the gathered
    net, bit for bit; the fused trainer's whole net, not its rows gathered
    again) and the global env lanes; its next iteration in one process
    agrees with the ranks' within the tolerance."""
    init_fn, step = _trainer(kind)
    state = restore_checkpoint(str(four_ranks["out"] / f"ck2x2_{kind}"),
                               like=init_fn(1))
    saved = four_ranks["arrays"][0][f"ck.{kind}.saved"]
    assert _flat(state.params).numpy().tobytes() == saved.tobytes()
    _, m = step(state)
    want = four_ranks["res"][0][f"ck.{kind}.after_save"]
    for k in ("loss", "mean_reward", "mean_value"):
        assert abs(float(m[k]) - want[k]) <= TOL * max(1.0, abs(want[k])), k


def test_train_cli_model_axis_on_the_cpu(four_ranks):
    """``--multihost --model-axis 2`` over 4 gloo ranks: a ``2x2`` mesh,
    the scan trainer with the update kernel's plain version on the
    gathered net, then the beer game; rank 0 alone logs and writes the
    checkpoint."""
    lead, *others = four_ranks["stdout"]
    assert "fused_collect=False fused_update=True" in lead
    assert lead.count("backend=gloo world=4 mesh=2x2") == 2
    assert all("# engine" not in o for o in others)
    assert os.path.isfile(four_ranks["out"] / "ck_cli" / "step_2.pt")
    for res in four_ranks["res"]:
        assert np.isfinite(res["cli_loss"]) and np.isfinite(
            res["cli_bg_loss"])


def test_mesh_axes_collectives_and_world_refusal(four_ranks):
    """Rank r sits at ``divmod(r, model)``; a model axis that does not
    divide the world raises; the trainers' collectives are counted on the
    axis they ran over (no model collective on ``4x1``, no data collective
    on ``1x4``)."""
    for r, res in enumerate(four_ranks["res"]):
        assert res["2x2.index"] == [r // 2, r % 2]
        assert res["4x1.index"] == [r, 0] and res["1x4.index"] == [0, r]
        assert "!= 4 processes" in res["world_refused"]
        assert res["4x1.stats"]["model"] == 0 < res["4x1.stats"]["data"]
        assert res["1x4.stats"]["data"] == 0 < res["1x4.stats"]["model"]
        assert min(res["2x2.stats"].values()) > 0


def test_beergame_table_draw_lane0_slices_equal_the_whole():
    """``make_beergame_table_draw``'s ``lane0``: the tables of a slice of
    lanes are those lanes of the whole batch's draw, bit for bit."""
    draw = make_beergame_table_draw(35, (0, 12), (0, 4), device="cpu")
    full = draw((7, 3), B)
    for lo, n in ((0, 4), (4, 4), (8, 8), (13, 3)):
        part = draw((7, 3), n, lane0=lo)
        for f, p in zip(full, part):
            assert torch.equal(f[..., lo:lo + n], p)


def test_shard_params_refuses_a_model_axis_that_does_not_divide():
    """A model axis that does not divide a hidden width stops at build
    time, in ``shard_params``, ``make_ppo`` and ``make_beergame_ppo``."""
    three = pm.Mesh(data=1, model=3, rank=1, world=3,
                    device=torch.device("cpu"), backend="gloo")
    model = policy.ActorCritic(policy.MLPConfig(9, 5, (16, 16)),
                               torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="divisible by the model axis 3"):
        policy.shard_params(model, three)
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    with pytest.raises(ValueError, match="model axis 3"):
        ppo.make_ppo(cc, 12, ppo.PPOConfig(hidden=(16,)), device="cpu",
                     mesh=three)
    with pytest.raises(ValueError, match="model axis 3"):
        ppo.make_beergame_ppo(12, ppo.PPOConfig(hidden=(8,)), device="cpu",
                              mesh=three)
    # rank 1 of 3 keeps rows 4..7 of a width of 12
    twelve = policy.ActorCritic(policy.MLPConfig(9, 5, (12,)),
                                torch.Generator().manual_seed(0), "cpu")
    w = twelve.actor[0].w.detach().clone()
    policy.shard_params(twelve, three)
    assert torch.equal(twelve.actor[0].w, w[4:8])
    assert twelve.mu.w.shape == (5, 12)
