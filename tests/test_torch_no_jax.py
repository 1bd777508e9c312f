"""The port imports no jax: every module of ``gym_supplychain_tpu_torch``
(the evaluation, large-topology, beer-game learning and host-stream slices'
among them) and ``chip_smoke.py`` load in a fresh interpreter without it."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import gym_supplychain_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("gym_supplychain_tpu.") or m == "gym_supplychain_tpu")
print(len(names), bad)
print(" ".join(names))
assert not bad, bad
assert "gymnasium" not in sys.modules   # imported only by the adapters
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 42, res.stdout
    loaded = set(res.stdout.splitlines()[1].split())
    for name in ("ops.supplychain_episode", "learn.evaluate",
                 "learn.heuristics", "learn.compare_baseline",
                 "utils.checkpoint", "ops.supplychain_dense",
                 "ops.beergame_episode", "benchmarks.large_topologies",
                 "ops.ppo_update", "learn.ppo", "models.policy",
                 "learn.compare_baseline_beergame", "learn.bars", "native",
                 "rng.host", "rng.gym_compat", "envs.strict_obs", "envs.single",
                 "envs.beergame", "envs.gym_registry", "parallel.mesh",
                 "benchmarks.multihost_scaling", "utils.profiling"):
        assert "gym_supplychain_tpu_torch." + name in loaded, name
