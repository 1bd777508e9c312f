"""Worker process for tests/test_torch_parallel.py: one rank of a 2-process
gloo group on the CPU (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` from the launcher).  Runs the port's data-parallel trainers,
one fused iteration's collectives (the ``collective.*`` counters and the
``mesh.data_all_reduce`` spans), the mesh form of the update on the
launcher's data, a checkpoint round trip each way and the train CLI with
``--multihost`` and ``--trace-dir``, and writes what the tests check under
``OUT`` (one ``.npz`` and one ``.json`` a rank).

    python tests/torch_parallel_worker.py OUT CLI_PORT
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
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    ActorCritic, MLPConfig)
from gym_supplychain_tpu_torch.parallel.mesh import (  # noqa: E402
    init_distributed, make_mesh, replicated)
from gym_supplychain_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)
from gym_supplychain_tpu_torch.utils.profiling import (  # noqa: E402
    counters, enable, reset_counters, take)

B, T, HIDDEN = 16, 6, (16, 16)
CASES = {"fused-prng": ("fused", "prng"), "fused-table": ("fused", "table"),
         "scan": ("scan", None)}


def trainer(kind, noise, mesh):
    cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
    cfg = ppo.PPOConfig(rollout_steps=T, epochs=2, hidden=HIDDEN)
    if kind == "fused":
        return ppo.make_ppo_fused(cc, B, cfg, noise=noise, mesh=mesh)
    return ppo.make_ppo(cc, B, cfg, mesh=mesh)


def flat(state):
    return torch.cat([p.detach().reshape(-1) for p in state.params.flat()])


def env_arrays(state, tag):
    return {f"{tag}.{k}": v.numpy() for k, v in state.env.env._asdict().items()
            if isinstance(v, torch.Tensor)}


def main():
    out, cli_port = sys.argv[1], sys.argv[2]
    dev = init_distributed(device="cpu")
    mesh = make_mesh(device=dev)
    rank = mesh.rank
    res, arrays = {"rank": rank, "world": mesh.world}, {}

    # the trainers: the first iteration's metrics, the parameters after 3
    for name, (kind, noise) in CASES.items():
        init_fn, step = trainer(kind, noise, mesh)
        state = init_fn(0)
        metrics = []
        for _ in range(3):
            state, m = step(state)
            metrics.append({k: float(v) for k, v in m.items()})
        res[name] = {"metrics": metrics,
                     "replicated": replicated(mesh, flat(state))}
        arrays[f"{name}.params"] = flat(state).numpy()

    # the exchange: one fused iteration's collectives, counted, in spans
    for epochs in (1, 2):
        cc = sct.make_chain("supplychain-ntom-v0", total_time_steps=T)
        init_fn, step = ppo.make_ppo_fused(
            cc, B, ppo.PPOConfig(epochs=epochs, hidden=HIDDEN), mesh=mesh)
        state = init_fn(0)
        reset_counters()
        take()
        was = enable(True)
        try:
            step(state)
        finally:
            enable(was)
        res[f"exchange{epochs}"] = {
            "counters": {k: v for k, v in counters().items()
                         if k.startswith("collective.")},
            "params": sum(p.numel() for p in state.params.flat()),
            "parents": [s.parent for s in take()
                        if s.name == "mesh.data_all_reduce"]}

    # the mesh form of the update on the launcher's data: the rank's lanes
    data = np.load(os.path.join(out, "update_data.npz"))
    lo, hi = rank * data["obs"].shape[-1] // 2, (rank + 1) * data[
        "obs"].shape[-1] // 2
    O, A = data["obs"].shape[0], data["pre"].shape[0]
    local = tuple(torch.from_numpy(np.ascontiguousarray(data[k][..., lo:hi]))
                  for k in ("obs", "pre", "old", "adv", "ret"))
    for fused in (False, True):
        cfg = ppo.PPOConfig(hidden=tuple(int(h) for h in data["hidden"]),
                            epochs=2, lr=1e-3, max_grad_norm=0.05,
                            fused_update=fused)
        model = ActorCritic(MLPConfig(O, A, cfg.hidden), device="cpu")
        with torch.no_grad():
            for p, k in zip(model.flat(), sorted(
                    (k for k in data.files if k.startswith("leaf")),
                    key=lambda k: int(k[4:]))):
                p.copy_(torch.from_numpy(data[k]))
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        losses = ppo._make_update(cfg, ppo._make_cont_loss(cfg), dims=(O, A),
                                  mesh=mesh)(model, opt, local)
        arrays[f"update{int(fused)}.losses"] = losses.numpy()
        for i, p in enumerate(model.flat()):
            arrays[f"update{int(fused)}.leaf{i}"] = p.detach().numpy()

    # checkpoints: 2 ranks write and resume; a 1-process file restores here
    init_fn, step = trainer("scan", None, mesh)
    state = init_fn(0)
    for _ in range(2):
        state, _ = step(state)
    ck = os.path.join(out, "ck2")
    save_checkpoint(ck, state, step=2, mesh=mesh)
    arrays["saved.params"] = flat(state).numpy()
    arrays.update(env_arrays(state, "saved"))
    state, m = step(state)
    res["after_save"] = {k: float(v) for k, v in m.items()}
    arrays["cont.params"] = flat(state).numpy()
    fresh = restore_checkpoint(ck, like=init_fn(1), mesh=mesh)
    fresh, _ = step(fresh)
    res["resume_bit_exact"] = bool(torch.equal(flat(fresh), flat(state)))
    one = restore_checkpoint(os.path.join(out, "ck1"), like=init_fn(1),
                             mesh=mesh)
    arrays.update(env_arrays(one, "from1"))
    arrays["from1.params"] = flat(one).numpy()
    one, m = step(one)
    res["from1_next"] = {k: float(v) for k, v in m.items()}
    dist.destroy_process_group()

    # the train CLI, in a group of its own
    os.environ["MASTER_PORT"] = cli_port
    tr = os.path.join(out, "trace")
    _, m = train.main(["--envs", str(B), "--hidden", "8", "--horizon", str(T),
                       "--rollout-steps", "4", "--iters", "2",
                       "--log-every", "1", "--device", "cpu", "--multihost",
                       "--trace-dir", tr, "--checkpoint-dir",
                       os.path.join(out, "ck_cli")])
    res["cli_loss"] = float(m["loss"])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    main()
