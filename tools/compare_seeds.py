"""Run the port's baseline comparisons at several seeds on the card and
write each report.

    python3 tools/compare_seeds.py [--seeds 0 1 2] [--configs sc2perstage
        ntom seasonal beergame] [--jobs 6] [--out-dir DIR]

The default configs are the commands ``docs/TRAINING.md`` records for the
JAX package's committed comparisons (``benchmarks/results/
compare_baseline_*.json``), run through the port's modules with ``--seed
k`` (``CONFIGS`` below); the ``<bar>-bar`` configs are the learning bars
of ``tests/test_vector_learn.py`` (``learn/bars.py``: their sizes,
iterations, grids and baselines) through the same CLIs.  Each run is a
process of its own on the one card (the trainers are host-bound, so runs
side by side share the card's idle time), ``--jobs`` at a time, each
limited to one host thread.  Each report is the CLI's JSON with a
``"card"`` entry added (the card's name and power limit from
``nvidia-smi``, the command, the run's wall seconds on the host clock,
``--jobs``), written to ``DIR/compare_baseline_<config>_h100_seed<k>.json``
(by default ``gym_supplychain_tpu_torch/results``).  Prints a line a run,
then each config's margins over its baseline (the grid's optimum, or the
bar's grid point; from the reports' mean returns, to three decimals of a
percent) and the worst, and for a bar whether each seed passes it; exits
nonzero if a run failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from gym_supplychain_tpu_torch.learn import bars  # noqa: E402

CLI = "gym_supplychain_tpu_torch.learn."
# docs/TRAINING.md's commands for the JAX artifacts, then the bars
CONFIGS = {
    "sc2perstage": ["compare_baseline", "--env", "sc-2perstage-v0",
                    "--horizon", "60", "--envs", "256", "--iters", "600"],
    "ntom": ["compare_baseline", "--env", "supplychain-ntom-v0", "--horizon",
             "360", "--envs", "4096", "--iters", "800", "--rollout", "32",
             "--lr", "3e-4", "--epochs", "4", "--hidden", "64", "64", "--zs",
             "0.002", "0.005", "0.01", "0.015", "0.02", "0.03", "0.05"],
    "seasonal": ["compare_baseline", "--env", "sc-2perstage-seasonal-v0",
                 "--horizon", "360", "--envs", "1024", "--iters", "800",
                 "--rollout", "32", "--lr", "3e-3", "--epochs", "4",
                 "--hidden", "64", "64"],
    "beergame": ["compare_baseline_beergame", "--envs", "256", "--iters",
                 "2000"],
    **{f"{name}-bar": [bar.cli, *bar.argv]
       for name, bar in bars.BARS.items()},
}
DOCS = ["sc2perstage", "ntom", "seasonal", "beergame"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--configs", nargs="+", default=DOCS,
                   choices=list(CONFIGS))
    p.add_argument("--jobs", type=int, default=6)
    p.add_argument("--out-dir",
                   default=str(ROOT / "gym_supplychain_tpu_torch" / "results"))
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if not smi:
        raise SystemExit("no card: the comparisons run on the card")
    print(smi, flush=True)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    todo = [(c, s) for c in args.configs for s in args.seeds]
    running, margins, failed = {}, {}, []
    while todo or running:
        while todo and len(running) < args.jobs:
            cfg, seed = todo.pop(0)
            cmd = [sys.executable, "-m", CLI + CONFIGS[cfg][0],
                   *CONFIGS[cfg][1:], "--seed", str(seed)]
            # files, not pipes: a full pipe would stall the run
            logs = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                    stdout=logs[0], stderr=logs[1])
            running[proc] = (cfg, seed, cmd, time.time(), logs)
        time.sleep(1)
        for proc in [q for q in running if q.poll() is not None]:
            cfg, seed, cmd, t0, logs = running.pop(proc)
            wall = time.time() - t0
            stdout, stderr = (f.seek(0) or f.read() for f in logs)
            if proc.returncode:
                failed.append((cfg, seed))
                print(f"{cfg} seed {seed}: exit {proc.returncode}\n"
                      f"{stderr[-2000:]}", flush=True)
                continue
            report = json.loads(stdout[stdout.index("{"):])
            report["card"] = {"nvidia_smi": smi, "command": cmd[2:],
                              "wall_seconds": round(wall, 1),
                              "jobs": args.jobs}
            path = out / f"compare_baseline_{cfg}_h100_seed{seed}.json"
            path.write_text(json.dumps(report, indent=1) + "\n")
            bar = cfg[:-4] if cfg.endswith("-bar") else None
            margin = bars.margin(report, bar and bars.BARS[bar].z)
            passes = f", passes: {bars.passes(bar, report)}" if bar else ""
            margins.setdefault(cfg, {})[seed] = margin
            print(f"{cfg} seed {seed}: {margin:.3%}{passes} ({wall:.0f} s) "
                  f"-> {path}", flush=True)
    for cfg, by_seed in margins.items():
        print(f"{cfg}: margins " + ", ".join(
            f"seed {k} {v:.3%}" for k, v in sorted(by_seed.items()))
            + f"; worst {min(by_seed.values()):.3%}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
