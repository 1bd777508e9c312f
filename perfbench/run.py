"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``: its configuration is the file that ``configs`` names, its
traffic ``perfbench/traffic/<traffic>.json``, whose ``kind`` names the
driver ``perfbench/drivers/<kind>.py``.  A per-layer metric is read by
``perfbench/metrics/<name>.py``.  Adding a configuration, a traffic mix or
a metric adds files and entries and edits none.

Set-up (``setup_s``: from the start of this process to the first timed
step) builds the program's objects from the seed and warms every shape the
cell uses.  ``--trace 0`` then runs the cell's steps for ``--seconds``
without a synchronize, marks each step's end with a CUDA event, and
reports the end-to-end metrics: env-steps of every step over the window,
which ends in a synchronize, and the 95th percentile of the gaps between
the events.  ``--trace 1`` runs the steps phase by phase in the
benchmark's spans (``record_function`` and CUDA events around each) for
``--seconds``, then profiles a few more steps with ``torch.profiler`` and
reports the per-layer metrics, the device's busy time and the breakdown.

After the window the plain reference (``perfbench/reference``) checks
what the timed steps produced (``drivers/<kind>.py``); each number
compared is printed beside its limit, last on standard error and last in
the result's line.  The last line of standard output is the result.
Without a CUDA device, or with fewer than the cell asks for, the run
exits 3 and prints no result; with JAX or the JAX package loaded, 4.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_supplychain_tpu")
SPAN_PREFIX = "pb."


def _applies(metric: dict, cell: str):
    """Whether the cell reports ``metric``: the cells it lists, or every
    cell where it lists none."""
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str):
    """``(workload, configuration, traffic, end-to-end metrics, per-layer
    metrics)`` of the cell ``name``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    wl = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((ROOT / files[wl["config"]]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json"
                          ).read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return wl, config, traffic, e2e, layer


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Marks:
    """Marks on the device's stream (CUDA events), or on the host's clock
    where there is no card; ``ms(a, b)`` reads the gap after a
    synchronize."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.torch = torch

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


class Spans:
    """The benchmark's spans: ``with spans(name):`` marks the block with
    ``record_function`` on the host and with a mark on each side;
    ``ms()`` gives each span's durations, in order."""

    def __init__(self, marks: Marks):
        from torch.profiler import record_function

        self.marks, self.record = marks, record_function
        self.pairs = {}

    def __call__(self, name):
        spans = self

        class _Span:
            def __enter__(self):
                self.rf = spans.record(SPAN_PREFIX + name)
                self.rf.__enter__()
                self.a = spans.marks.mark()

            def __exit__(self, *exc):
                spans.pairs.setdefault(name, []).append(
                    (self.a, spans.marks.mark()))
                self.rf.__exit__(*exc)

        return _Span()

    def ms(self):
        return {k: [self.marks.ms(a, b) for a, b in v]
                for k, v in self.pairs.items()}


def _p95(values):
    return statistics.quantiles(values, n=20, method="inclusive")[18] \
        if len(values) > 1 else values[0]


def _profile(cell, spans, marks, steps, span_names):
    """``steps`` steps under ``torch.profiler`` -> (busy s, window s,
    device seconds by span, breakdown)."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace

    acts = [ProfilerActivity.CPU]
    if marks.cuda:
        acts.append(ProfilerActivity.CUDA)
    marks.sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            cell.step_spans(spans)
        marks.sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace.load(path)
    finally:
        os.remove(path)
    names = [SPAN_PREFIX + n for n in span_names]
    strip = lambda d: {(k[len(SPAN_PREFIX):] if k else k): v  # noqa: E731
                       for k, v in d.items()}
    bd = trace.breakdown(events, names)
    bd["idle_gaps"] = [[k[len(SPAN_PREFIX):] if k.startswith(SPAN_PREFIX)
                        else k, v] for k, v in bd["idle_gaps"]]
    return (trace.busy_us(events) / 1e6, window,
            strip(trace.attribute(events, names)), bd)


def _device(peak: int, cuda: bool):
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": peak}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        dev["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return dev


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", override=None):
    """Run the cell once on ``device`` and return its result (a dict in
    the order it is printed).  ``override`` updates the configuration's
    and the traffic's keys (``{"config": {...}, "traffic": {...}}``), for
    tests at a size the CPU holds."""
    import torch

    _, config, traffic, e2e, layer = load_cell(name)
    override = override or {}
    config = {**config, **override.get("config", {})}
    traffic = {**traffic, **override.get("traffic", {})}
    torch.set_num_threads(1)
    # float32 means float32: no configuration runs its matmuls in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
    marks = Marks(device)
    spans = Spans(marks) if trace else None
    ctx = types.SimpleNamespace(config=config, traffic=traffic,
                                seed=int(seed), device=device, spans=spans)
    t_build = time.perf_counter()
    cell = driver.build(ctx)
    print(f"setup: {t_build - T_START:.2f} s to the build, "
          f"{time.perf_counter() - t_build:.2f} s the build and warm-up",
          file=sys.stderr)
    if trace and marks.cuda:
        # CUPTI starts with the first profiler: before the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            marks.sync()
    marks.sync()
    setup_s = time.perf_counter() - T_START
    metrics, extra = {}, {}
    t0 = time.perf_counter()
    if not trace:
        ends = [marks.mark()]
        while time.perf_counter() - t0 < seconds:
            cell.step()
            ends.append(marks.mark())
        marks.sync()
        window = time.perf_counter() - t0
        steps = len(ends) - 1
        gaps = [marks.ms(a, b) for a, b in zip(ends, ends[1:])]
        values = {driver.RATE: cell.work * steps / window,
                  driver.TAIL: _p95(gaps), "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in e2e}
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in units}
        print(f"window {window:.3f} s, {steps} steps, median step "
              f"{statistics.median(gaps):.4f} ms", file=sys.stderr)
    else:
        steps = 0
        while time.perf_counter() - t0 < seconds:
            cell.step_spans(spans)
            steps += 1
        marks.sync()
        window = time.perf_counter() - t0
        n_prof = int(traffic["profile_steps"])
        busy, prof_window, kernel_s, bd = _profile(cell, spans, marks,
                                                   n_prof, driver.SPANS)
        steps += n_prof
        run = types.SimpleNamespace(
            spans=spans.ms(), kernel_s=kernel_s, profiled_steps=n_prof,
            busy_s=busy, window_s=prof_window, steps=steps - n_prof,
            window_total_s=window, shape=cell.shape)
        for m in layer:
            v = _reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": busy, "window_s": prof_window}
        print(f"window {window:.3f} s, {steps - n_prof} steps; profiled "
              f"{n_prof} steps, {prof_window:.4f} s, device seconds by "
              f"span {kernel_s}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if marks.cuda else 0
    dev = {**_device(peak, marks.cuda), **extra}
    cell.release()
    t_check = time.perf_counter()
    numbers = cell.check()
    print(f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    limits = traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = bd
    result["checks"] = checks
    return result


def loaded_forbidden():
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description="Run one cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    wl = load_cell(args.workload)[0]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(wl["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{wl['chips']}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
