"""The learning bars' spread over seeds, on the CPU, for the port or for
the JAX package, and which side's draws and scoring a margin moves with.

    python3 tools/learning_spread.py --package port|jax --bar ntom
        [--seeds 0 1 2] [--x64] [--init port|jax] [--score port [jax]]

Runs one bar of ``tests/test_vector_learn.py`` (``sc2perstage``, ``ntom``,
``seasonal``, ``beergame``) at its sizes, iterations, hyperparameters and
baseline grid, as ``gym_supplychain_tpu_torch/learn/bars.py`` gives them
to the port's comparison CLIs, at each seed: the baseline's key and the
trainer's seed are the seed, the greedy evaluations' key the seed + 1
(the JAX tests use seed 0).  ``--package`` picks the trainer: the port's
with ``device="cpu"`` (the plain versions of its kernels) or the JAX
package's on its CPU backend, in float32 or with ``--x64`` in the tier-1
harness's x64 mode.  ``--init`` picks the initial weights, whichever
package trains: the port's for the seed (``init_fn(seed)``) or the JAX
package's (``init_fn(PRNGKey(seed))``); the supply chains only.  ``--score``
names the packages whose evaluator and baseline grid score the run, each
on its own keys for the seed; the supply chains can score with either
package whatever trained them, the beer game with its own.  Prints one
JSON line a seed: under ``"by"``, for each scorer, the baseline grid, the
bar's baseline (base stock at z = 2.0 for sc2perstage, else the grid
optimum), the greedy return and its margin at every tenth of the
iterations, and the final margin; then the seconds.  One process runs
its seeds in turn; start one a seed to run them side by side.

    python3 tools/learning_spread.py --summarize FILE.jsonl [...]

reads such lines back (``gym_supplychain_tpu_torch/results/
learning_spread/`` holds the committed ones) and prints, for each group
of runs (bar, x64, trainer, initial weights, scorer), its seeds' median,
worst and the seeds at or below the bar's margin, then for each two
groups of a bar a rank test of their margins (Mann-Whitney) and, where
they share 6 seeds or more, a signed-rank test of the per-seed
differences (Wilcoxon).  Lines written before ``--init`` and ``--score``
(flat ``margin``, and ``jax_init`` for the JAX package's weights and
scoring) read as the package's own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _config(name, args):
    """(PPOConfig keywords, the beer game's env keywords or None) of the
    bar ``name``'s parsed CLI flags ``args``."""
    cfg = dict(rollout_steps=args.rollout, hidden=tuple(args.hidden),
               lr=args.lr, epochs=args.epochs)
    if name != "beergame":
        return cfg, None
    from gym_supplychain_tpu_torch.learn.compare_baseline_beergame import (
        env_kwargs)

    return dict(cfg, ent_coef=args.ent), env_kwargs(args)


def _port_trainer(name, args, seed):
    """(train_step, state) of the port's trainer from ``seed``."""
    from gym_supplychain_tpu_torch import make_chain
    from gym_supplychain_tpu_torch.learn import ppo

    cfg, kw = _config(name, args)
    if kw is not None:
        init_fn, step = ppo.make_beergame_ppo(args.envs, ppo.PPOConfig(**cfg),
                                              device="cpu", **kw)
    else:
        cc = make_chain(args.env, total_time_steps=args.horizon)
        init_fn, step = ppo.make_ppo(cc, args.envs, ppo.PPOConfig(**cfg),
                                     device="cpu")
    return step, init_fn(seed)


def _jax_trainer(name, args, seed):
    import jax

    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.learn.ppo import (PPOConfig, make_beergame_ppo,
                                               make_ppo)

    cfg, kw = _config(name, args)
    if kw is not None:
        kw = {k: v for k, v in kw.items() if k != "levels"}
        init_fn, step = make_beergame_ppo(
            args.envs, PPOConfig(**cfg, rollout_unroll=1), **kw)
    else:
        cc = sct.make(args.env, total_time_steps=args.horizon).cc
        init_fn, step = make_ppo(cc, args.envs, PPOConfig(**cfg))
    return jax.jit(step), init_fn(jax.random.PRNGKey(seed))


def _port_scorer(name, args, seed):
    """(grid, evaluate(port params) -> mean return) on the port's keys."""
    from gym_supplychain_tpu_torch import make_chain
    from gym_supplychain_tpu_torch.learn.evaluate import (
        make_beergame_evaluator, make_evaluator)
    from gym_supplychain_tpu_torch.learn.heuristics import (
        best_base_stock, best_beergame_base_stock)

    _, kw = _config(name, args)
    if kw is not None:
        _, _, grid = best_beergame_base_stock(
            args.envs, seed, targets=args.targets,
            episodes=args.eval_episodes, device="cpu", **kw)
        ev = make_beergame_evaluator(args.envs, device="cpu", **kw)
    else:
        cc = make_chain(args.env, total_time_steps=args.horizon)
        _, _, grid = best_base_stock(
            cc, args.grid_envs or args.envs, seed, zs=args.zs,
            episodes=args.grid_episodes or args.eval_episodes, device="cpu")
        ev = make_evaluator(cc, args.envs, device="cpu")
    return grid, lambda p: float(ev(p, seed + 1, args.eval_episodes)
                                 ["mean_return"])


def _jax_scorer(name, args, seed):
    import jax

    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.learn.evaluate import (make_beergame_evaluator,
                                                    make_evaluator)
    from gym_supplychain_tpu.learn.heuristics import (
        best_base_stock, best_beergame_base_stock)

    key = jax.random.PRNGKey
    _, kw = _config(name, args)
    if kw is not None:
        _, _, grid = best_beergame_base_stock(
            args.envs, key(seed), targets=args.targets,
            episodes=args.eval_episodes, **kw)
        ev = make_beergame_evaluator(args.envs, **kw)
    else:
        cc = sct.make(args.env, total_time_steps=args.horizon).cc
        _, _, grid = best_base_stock(
            cc, args.grid_envs or args.envs, key(seed), zs=args.zs,
            episodes=args.grid_episodes or args.eval_episodes)
        ev = make_evaluator(cc, args.envs)
    ev = jax.jit(ev, static_argnames="episodes")
    return grid, lambda p: float(ev(p, key(seed + 1), args.eval_episodes)
                                 ["mean_return"])


def _to(package, params):
    """Actor-critic parameters of the other package, in ``package``'s
    form."""
    import jax
    import numpy as np

    from gym_supplychain_tpu_torch.models.policy import (params_from_jax,
                                                         params_to_numpy)

    if package == "jax":
        return jax.tree.map(jax.numpy.asarray, params_to_numpy(params))
    return params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        params), device="cpu")


def _run(name, cli, flags, seed):
    """Train the bar ``name`` (its CLI flags ``cli``) from ``seed`` as
    ``flags`` say and score it -> {scorer: its row}."""
    from gym_supplychain_tpu_torch.learn.bars import BARS

    scorers = {s: {"port": _port_scorer, "jax": _jax_scorer}[s](
        name, cli, seed) for s in flags.score}
    trainer = _port_trainer if flags.package == "port" else _jax_trainer
    step, state = trainer(name, cli, seed)
    if flags.init == "jax" and flags.package == "port":
        import torch

        _, jstate = _jax_trainer(name, cli, seed)
        with torch.no_grad():
            for p, q in zip(state.params.flat(),
                            _to("port", jstate.params).flat()):
                p.copy_(q)
    elif flags.init == "port" and flags.package == "jax":
        # Adam's moments start at zero whatever the weights
        _, pstate = _port_trainer(name, cli, seed)
        state = state._replace(params=_to("jax", pstate.params))
    rows = {}
    for s, (grid, evaluate) in scorers.items():
        z = BARS[name].z
        heur = grid[z] if z is not None else max(grid.values())
        if s != flags.package:
            evaluate = (lambda ev, to: lambda p: ev(_to(to, p)))(evaluate, s)
        rows[s] = {"grid": {str(k): v for k, v in grid.items()},
                   "baseline": heur, "curve": [], "evaluate": evaluate}
    iters = cli.iters
    for it in range(iters):
        state, _ = step(state)
        if (it + 1) % (iters // 10) == 0:
            for row in rows.values():
                ret = row["evaluate"](state.params)
                row["curve"].append([it + 1, ret, (ret - row["baseline"])
                                     / abs(row["baseline"])])
    for row in rows.values():
        del row["evaluate"]
        row["margin"] = row["curve"][-1][2]
    return rows


def summarize(paths):
    """Print each group's spread and the rank tests between groups (the
    module's docstring)."""
    import itertools

    import numpy as np
    from scipy import stats

    from gym_supplychain_tpu_torch.learn.bars import BARS

    groups = {}
    for path in paths:
        for line in open(path):
            r = json.loads(line)
            if "by" in r:
                runs = [(r["init"], s, v["margin"]) for s, v in r["by"].items()]
            else:
                own = "jax" if r.get("jax_init") else r["package"]
                runs = [(own, own, r["margin"])]
            for init, scorer, m in runs:
                key = (r["bar"], r["x64"], r["package"], init, scorer)
                groups.setdefault(key, {})[r["seed"]] = 100 * m
    for key, by_seed in sorted(groups.items()):
        bar, x64, package, init, scorer = key
        seeds = sorted(by_seed)
        worst = min(seeds, key=by_seed.get)
        below = [k for k in seeds if by_seed[k] <= 100 * BARS[bar].margin]
        print(f"{bar} x64={x64} train {package} init {init} score {scorer}: "
              f"{len(seeds)} seeds, median "
              f"{np.median(list(by_seed.values())):.3f}%, worst "
              f"{by_seed[worst]:.3f}% (seed {worst}), at or below the bar's "
              f"{100 * BARS[bar].margin:g}%: seeds {below}")
    for (ka, a), (kb, b) in itertools.combinations(sorted(groups.items()), 2):
        if ka[:2] != kb[:2]:
            continue
        line = (f"{ka[0]} x64={ka[1]}: {'/'.join(ka[2:])} against "
                f"{'/'.join(kb[2:])}: Mann-Whitney p "
                f"{stats.mannwhitneyu(list(a.values()), list(b.values())).pvalue:.3f}")
        shared = sorted(set(a) & set(b))
        if len(shared) >= 6:
            d = np.array([a[k] - b[k] for k in shared])
            line += (f"; {len(shared)} shared seeds: median difference "
                     f"{np.median(d):.3f} points, Wilcoxon p "
                     f"{stats.wilcoxon(d).pvalue:.3f}, within 0.03 points "
                     f"{int((abs(d) < 0.03).sum())}, within 0.11 "
                     f"{int((abs(d) < 0.11).sum())}")
        print(line)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--summarize", nargs="+", metavar="FILE",
                   help="summarize these lines and exit")
    p.add_argument("--package", choices=("port", "jax"))
    p.add_argument("--bar",
                   choices=("sc2perstage", "ntom", "seasonal", "beergame"))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--x64", action="store_true",
                   help="the JAX package in x64 mode (tests/conftest.py's)")
    p.add_argument("--init", choices=("port", "jax"), default=None,
                   help="the trainer's initial weights (default: its own "
                        "package's)")
    p.add_argument("--score", choices=("port", "jax"), nargs="+",
                   default=None, help="the evaluators and grids that score "
                                      "the run (default: the package's)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.summarize:
        return summarize(args.summarize)
    if not (args.package and args.bar):
        p.error("--package and --bar (or --summarize)")
    args.init = args.init or args.package
    args.score = args.score or [args.package]
    if args.bar == "beergame" and (args.init != args.package
                                   or args.score != [args.package]):
        raise SystemExit("the beer game: its own package's init and scoring")
    import torch

    from gym_supplychain_tpu_torch.learn.bars import parse

    torch.set_num_threads(1)

    if "jax" in (args.package, args.init, *args.score):
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_enable_x64", args.x64)
    cli = parse(args.bar, "--device", "cpu")
    for seed in args.seeds:
        t0 = time.time()
        by = _run(args.bar, cli, args, seed)
        print(json.dumps({"package": args.package, "x64": args.x64,
                          "bar": args.bar, "seed": seed, "init": args.init,
                          "by": by, "seconds": round(time.time() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
