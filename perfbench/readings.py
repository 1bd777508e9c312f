"""The readings a cell's limits are set from, on the card at the cell's
own size.

    python3 -m perfbench.readings --workload <name> --what <what> \\
        --seeds <n> [<n> ...] [--seconds <s>]

``--what program`` runs the cell (a window of ``--seconds``) once a seed
and prints its numbers compared: the lower readings.  ``--what control``
prints the numbers with the configuration's control in the program's
place (the reference in the precision below the configured one: TF32 for
the float32 learner and evaluator, bfloat16 for the collection, whose
float32 arithmetic has no matmul): the upper readings.  ``--what
<fault>`` runs the cell with a fault of ``perfbench/faults.py`` planted.
One JSON line a seed; all in one process, so the library loads once.
"""
from __future__ import annotations

import argparse
import importlib
import json
import types

from . import faults, run


def readings(name: str, what: str, seed: int, seconds: float = 1.0,
             device: str = "cuda", override=None):
    """The numbers compared for one seed (``what`` as the command's)."""
    if what == "program":
        return {k: c["value"] for k, c in run.run_cell(
            name, seed, seconds, False, device, override)["checks"].items()}
    _, config, traffic, _, _ = run.load_cell(name)
    override = override or {}
    config = {**config, **override.get("config", {})}
    traffic = {**traffic, **override.get("traffic", {})}
    if what == "control":
        driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
        ctx = types.SimpleNamespace(config=config, traffic=traffic,
                                    seed=int(seed), device=device, spans=None)
        return driver.control(ctx)
    with faults.plant(traffic["kind"], what):
        return {k: c["value"] for k, c in run.run_cell(
            name, seed, seconds, False, device, override)["checks"].items()}


def main(argv=None):
    p = argparse.ArgumentParser(description="Readings for a cell's limits.")
    p.add_argument("--workload", required=True)
    p.add_argument("--what", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        out = readings(args.workload, args.what, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed, "numbers": out}), flush=True)


if __name__ == "__main__":
    main()
