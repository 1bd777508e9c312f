"""What the harness loads: never JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference nothing of the program; and no result without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "gym_supplychain_tpu"}


def _tops(code, cwd=ROOT):
    env = {**os.environ, "PYTHONPATH": str(cwd)}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    code = ["import perfbench.run, perfbench.readings, perfbench.faults"]
    for kind in sorted(p.stem for p in (ROOT / "perfbench/drivers").glob(
            "[a-z]*.py")):
        code.append(f"import perfbench.drivers.{kind}")
    for p in sorted((ROOT / "perfbench/metrics").glob("[a-z]*.py")):
        code.append(f"perfbench.run._reader({p.stem!r})")
    code.append("import perfbench.reference.ppo, perfbench.reference.rollouts")
    code.append("import gym_supplychain_tpu_torch.learn.ppo, "
                "gym_supplychain_tpu_torch.learn.evaluate, "
                "gym_supplychain_tpu_torch.ops.supplychain_collect")
    tops = _tops("\n".join(code))
    assert "gym_supplychain_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _tops("import perfbench.reference.ppo, "
                 "perfbench.reference.rollouts, perfbench.compare, "
                 "perfbench.counts")
    assert not tops & (FORBIDDEN | {"gym_supplychain_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    from perfbench import run

    before = dict(sys.modules)
    try:
        sys.modules.pop("gym_supplychain_tpu", None)
        sys.modules["gym_supplychain_tpu_torch_probe"] = sys
        assert "gym_supplychain_tpu" not in run.loaded_forbidden()
        sys.modules["gym_supplychain_tpu.probe"] = sys
        assert "gym_supplychain_tpu" in run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_no_result_without_a_card():
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "perfbench.run",
                          "--workload", "ntom-collect", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.');"
         "import perfbench.drivers.train as t, types;"
         "t.build(types.SimpleNamespace(config={}, traffic={}, seed=1,"
         " device='cpu', spans=None))"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "gym_supplychain_tpu_torch" in out.stderr
