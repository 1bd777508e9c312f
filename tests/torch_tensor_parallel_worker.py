"""Worker process for tests/test_torch_tensor_parallel.py: one rank of a
4-process gloo group on the CPU (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` from the launcher).  On ``2x2``, ``4x1`` and ``1x4`` meshes
over the same world it runs the tensor-parallel forwards and update on the
launcher's weights and data, the scan, fused and beer-game trainers, the
checkpoint round trips, then the train CLI with ``--multihost --model-axis
2``, and writes what the tests check under ``OUT`` (one ``.npz`` and one
``.json`` a rank).

    python tests/torch_tensor_parallel_worker.py OUT CLI_PORT BG_CLI_PORT
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import gym_supplychain_tpu_torch as sct  # noqa: E402
from gym_supplychain_tpu_torch.learn import ppo, train  # noqa: E402
from gym_supplychain_tpu_torch.models import policy  # noqa: E402
from gym_supplychain_tpu_torch.parallel.mesh import (  # noqa: E402
    barrier, init_distributed, lane_range, local_rows, make_mesh, replicated)
from gym_supplychain_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)

B, T, HIDDEN = 16, 6, (16, 16)
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
TRAINERS = {"2x2": ("scan", "beergame", "fused"), "4x1": ("scan", "beergame"),
            "1x4": ("scan",)}
BG = dict(v2=True, customer_demand=(0, 12), shipment_delays=(0, 4))


def trainer(kind, mesh):
    cfg = ppo.PPOConfig(rollout_steps=T, epochs=2, hidden=HIDDEN)
    if kind == "beergame":
        return ppo.make_beergame_ppo(B, cfg, device="cpu", mesh=mesh, **BG)
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    if kind == "fused":
        return ppo.make_ppo_fused(cc, B, cfg, device="cpu", mesh=mesh)
    return ppo.make_ppo(cc, B, cfg, device="cpu", mesh=mesh)


def tree(arrays, prefix):
    """The JAX parameter tree the launcher flattened under ``prefix``."""
    out = {}
    for key, x in arrays.items():
        if not key.startswith(prefix + "."):
            continue
        *path, leaf = key[len(prefix) + 1:].split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = x
    for trunk in ("actor", "critic"):
        out[trunk] = [out[trunk][str(i)] for i in range(len(out[trunk]))]
    return out


def flat(params):
    return torch.cat([p.detach().reshape(-1) for p in params.flat()])


def whole(kind, params, mesh):
    """The whole net of a trainer's parameters (the fused trainer keeps
    every leaf whole on a model axis)."""
    return params if kind == "fused" else policy.gather_params(params, mesh)


def replicated_leaves(params):
    trunk = {id(p) for p in policy.trunk_leaves(params)}
    return torch.cat([p.detach().reshape(-1) for p in params.flat()
                      if id(p) not in trunk])


@torch.no_grad()
def forwards(name, mesh, arrays, out):
    ac = policy.params_from_jax(tree(arrays, "ac"), device="cpu")
    obs = torch.from_numpy(arrays["obs_ac"])
    one = policy.actor_critic_forward(ac, obs, torch.bfloat16)
    policy.shard_params(ac, mesh)
    for tag, dtype in (("ac", None), ("ac_bf16", torch.bfloat16)):
        mu, log_std, v = policy.actor_critic_forward(ac, obs, dtype,
                                                     mesh=mesh)
        out.update({f"{name}.fwd.{tag}.mu": mu.numpy(),
                    f"{name}.fwd.{tag}.log_std": log_std.numpy(),
                    f"{name}.fwd.{tag}.v": v.numpy()})
    for k, x in zip(("mu", "log_std", "v"), one):
        out[f"{name}.fwd.ac_bf16_one.{k}"] = x.numpy()
    n = int(arrays["n_choices"])
    dac = policy.discrete_params_from_jax(tree(arrays, "dac"), n, "cpu")
    policy.shard_params(dac, mesh)
    logits, v = policy.discrete_forward(
        dac, torch.from_numpy(arrays["obs_dac"]), dac.cfg.act_dim, n,
        mesh=mesh)
    out.update({f"{name}.fwd.dac.logits": logits.numpy(),
                f"{name}.fwd.dac.v": v.numpy()})


def update(name, mesh, arrays, out):
    """The update on the rank's lanes of the launcher's data, from the
    launcher's weights; the whole net gathered after it."""
    lo, hi = lane_range(mesh, arrays["upd.obs"].shape[-1])
    local = tuple(torch.from_numpy(np.ascontiguousarray(
        arrays[f"upd.{k}"][..., lo:hi]))
        for k in ("obs", "pre", "old", "adv", "ret"))
    model0 = policy.params_from_jax(tree(arrays, "upd"), device="cpu")
    O, A, hidden = model0.cfg
    for fused in (False, True):
        cfg = ppo.PPOConfig(hidden=hidden, epochs=2, lr=1e-3,
                            max_grad_norm=0.05, fused_update=fused)
        model = policy.shard_params(
            policy.params_from_jax(tree(arrays, "upd"), device="cpu"), mesh)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        losses = ppo._make_update(
            cfg, ppo._make_cont_loss(cfg, mesh=mesh), dims=(O, A),
            mesh=mesh, sharded_params=True)(model, opt, local)
        out[f"{name}.update{int(fused)}.losses"] = losses.numpy()
        for i, p in enumerate(policy.gather_params(model, mesh).flat()):
            out[f"{name}.update{int(fused)}.leaf{i}"] = p.detach().numpy()


def trainers(name, mesh, res, out):
    for kind in TRAINERS[name]:
        init_fn, step = trainer(kind, mesh)
        state = init_fn(0)
        if kind == "beergame":
            for k in ("customer_demand", "shipment_delays"):
                out[f"{name}.beergame.{k}"] = getattr(state.env.env,
                                                      k).numpy()
        metrics = []
        for _ in range(3):
            state, m = step(state)
            metrics.append({k: float(v) for k, v in m.items()})
        net = whole(kind, state.params, mesh)
        repl = (flat(state.params) if kind == "fused"
                else replicated_leaves(state.params))
        res[f"{name}.{kind}"] = {
            "metrics": metrics, "replicated_leaves": replicated(mesh, repl),
            "gathered_trunk": replicated(mesh, flat(net))}
        out[f"{name}.{kind}.replicated"] = repl.numpy()
        out[f"{name}.{kind}.params"] = flat(net).numpy()


def checkpoints(mesh, out_dir, res, out):
    """A 1-process file into 2x2 (the rank's rows, or the whole net for
    the fused trainer); 2x2 writes, resumes, and its file goes through 1
    process and back into 2x2."""
    for kind in ("scan", "beergame", "fused"):
        split = kind != "fused"
        init_fn, step = trainer(kind, mesh)
        one = restore_checkpoint(os.path.join(out_dir, f"ck1_{kind}"))
        got = restore_checkpoint(os.path.join(out_dir, f"ck1_{kind}"),
                                 like=init_fn(1), mesh=mesh)
        rows = (policy.shard_params(one["params"], mesh) if split
                else one["params"])
        res[f"ck.{kind}.from1_rows"] = all(
            torch.equal(a, b) for a, b in zip(got.params.flat(), rows.flat()))
        names = [n for n, _ in got.params.named_parameters()]
        mine = got.opt.state_dict()["state"]
        res[f"ck.{kind}.from1_moments"] = all(
            torch.equal(mine[i][k], local_rows(mesh, x) if split
                        and names[i].startswith(("actor.", "critic.")) else x)
            for i, v in one["opt"]["state"].items()
            for k, x in v.items() if k != "step")

        state = init_fn(0)
        for _ in range(2):
            state, _ = step(state)
        ck = os.path.join(out_dir, f"ck2x2_{kind}")
        save_checkpoint(ck, state, step=2, mesh=mesh)
        out[f"ck.{kind}.saved"] = flat(whole(kind, state.params,
                                             mesh)).numpy()
        state, m = step(state)
        cont = flat(whole(kind, state.params, mesh))
        res[f"ck.{kind}.after_save"] = {k: float(v) for k, v in m.items()}
        fresh, _ = step(restore_checkpoint(ck, like=init_fn(1), mesh=mesh))
        res[f"ck.{kind}.resume_bit_exact"] = bool(torch.equal(
            flat(whole(kind, fresh.params, mesh)), cont))
        # 2x2 -> 1 process (rank 0 alone) -> 2x2
        round_trip = os.path.join(out_dir, f"ck_round_{kind}")
        if mesh.rank == 0:
            init1, _ = trainer(kind, None)
            save_checkpoint(round_trip, restore_checkpoint(ck, like=init1(1)),
                            step=2)
        barrier(mesh)
        back, _ = step(restore_checkpoint(round_trip, like=init_fn(1),
                                          mesh=mesh))
        res[f"ck.{kind}.round_trip_bit_exact"] = bool(torch.equal(
            flat(whole(kind, back.params, mesh)), cont))


def main():
    out_dir, cli_port, bg_cli_port = sys.argv[1:4]
    arrays = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    dev = init_distributed(device="cpu")
    res, out = {}, {}
    try:
        make_mesh(model=3, device=dev)
    except ValueError as e:
        res["world_refused"] = str(e)
    for name, (d, m) in MESHES.items():
        mesh = make_mesh(d, m, device=dev)
        res[f"{name}.index"] = [mesh.data_index, mesh.model_index]
        if m > 1:
            forwards(name, mesh, arrays, out)
            update(name, mesh, arrays, out)
        trainers(name, mesh, res, out)
        if name == "2x2":
            checkpoints(mesh, out_dir, res, out)
        res[f"{name}.stats"] = mesh.stats
    rank = dist.get_rank()
    dist.destroy_process_group()

    # the train CLI, each run in a group of its own
    cli = ["--envs", str(B), "--hidden", "8", "--horizon", str(T),
           "--rollout-steps", "4", "--iters", "2", "--log-every", "1",
           "--device", "cpu", "--multihost", "--model-axis", "2"]
    os.environ["MASTER_PORT"] = cli_port
    _, m = train.main(cli + ["--fused-update", "--checkpoint-dir",
                             os.path.join(out_dir, "ck_cli")])
    res["cli_loss"] = float(m["loss"])
    os.environ["MASTER_PORT"] = bg_cli_port
    _, m = train.main(cli + ["--env", "beergame-v2"])
    res["cli_bg_loss"] = float(m["loss"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    main()
