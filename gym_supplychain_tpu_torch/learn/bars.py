"""The JAX package's four learning bars (``tests/test_vector_learn.py``)
as arguments of the port's comparison CLIs.

A bar is a CLI (``compare_baseline`` or ``compare_baseline_beergame``),
the arguments that give the JAX test's sizes, iterations,
hyperparameters and baseline grid, the margin by which the trained
greedy return must beat its baseline, and which baseline that is: the
grid's optimum, or the grid point ``z`` (sc-2perstage holds base stock at
z = 2.0).  The seasonal and beer-game grids must have an interior
optimum.  ``--seed k`` picks the draw: the baseline on key k, the trainer
from seed k, the greedy evaluation on key k + 1 (the JAX tests use 0).
Arguments given after a bar's override its own (argparse keeps the last),
so a test can run a bar's code path at a tiny size:

    from gym_supplychain_tpu_torch.learn import bars
    report = bars.run("ntom", "--seed", "1")             # on the card
    bars.margin(report), bars.passes("ntom", report)
"""
from __future__ import annotations

import importlib
from typing import NamedTuple, Optional


class Bar(NamedTuple):
    cli: str                    # a module of this package
    argv: tuple
    margin: float               # the trained return's least margin
    z: Optional[float] = None   # the baseline's grid point; None: optimum
    interior: bool = False      # the grid's optimum must be interior
    test: str = ""              # the JAX test at tests/test_vector_learn.py


def _net(iters, lr):
    return ("--horizon", "60", "--envs", "256", "--iters", str(iters),
            "--rollout", "32", "--lr", lr, "--epochs", "4", "--hidden", "64",
            "64", "--eval-episodes", "1")


BARS = {
    "sc2perstage": Bar(
        "compare_baseline",
        ("--env", "sc-2perstage-v0", *_net(220, "3e-3"), "--zs", "0.5",
         "1.0", "1.5", "2.0", "2.5", "3.0"),
        0.05, z=2.0, test="test_supplychain_ppo_beats_base_stock"),
    "ntom": Bar(
        "compare_baseline",
        ("--env", "supplychain-ntom-v0", *_net(500, "3e-4"), "--grid-envs",
         "128", "--grid-episodes", "2", "--zs", "0.01", "0.03", "0.05",
         "0.08", "0.1", "0.15"),
        0.002, test="test_ntom_ppo_matches_tuned_base_stock"),
    "seasonal": Bar(
        "compare_baseline",
        ("--env", "sc-2perstage-seasonal-v0", *_net(800, "3e-3"),
         "--grid-envs", "128", "--grid-episodes", "2", "--zs", "1.0", "1.5",
         "2.0", "2.5", "3.0"),
        0.08, interior=True, test="test_seasonal_ppo_beats_base_stock"),
    "beergame": Bar(
        "compare_baseline_beergame",
        ("--envs", "256", "--iters", "1500", "--rollout", "35", "--lr",
         "1e-3", "--epochs", "4", "--ent", "5e-3", "--hidden", "64", "64",
         "--eval-episodes", "8", "--targets", *map(str, range(12, 41, 4))),
        0.02, interior=True, test="test_beergame_ppo_beats_order_up_to"),
}


def _cli(name):
    return importlib.import_module(f".{BARS[name].cli}", __package__)


def parse(name, *extra):
    """The bar's CLI flags, parsed (``extra`` after the bar's)."""
    return _cli(name).parser().parse_args([*BARS[name].argv, *extra])


def run(name, *extra):
    """Run the bar's CLI (``extra`` after the bar's arguments) and return
    its report (the CLI also prints it)."""
    return _cli(name).main([*BARS[name].argv, *extra])


def _baseline(report):
    return report["base_stock" if "base_stock" in report else "order_up_to"]


def margin(report, z=None):
    """The trained greedy return's margin over the report's baseline: the
    grid's optimum, or its point ``z``."""
    base = _baseline(report)
    heur = base["mean_return"] if z is None else base["grid"][str(float(z))]
    return (report["ppo"]["greedy_mean_return"] - heur) / abs(heur)


def interior(report):
    """Whether the grid's optimum has a grid point on either side."""
    base = _baseline(report)
    points = sorted(float(k) for k in base["grid"])
    best = base.get("best_z", base.get("best_target"))
    return points[0] < float(best) < points[-1]


def passes(name, report):
    """Whether a report meets its bar: the margin over the bar's baseline,
    and an interior optimum where the bar asks for one."""
    bar = BARS[name]
    return (margin(report, bar.z) > bar.margin
            and (interior(report) or not bar.interior))
