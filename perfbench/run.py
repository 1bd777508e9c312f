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

A cell whose ``chips`` is more than 1 runs a rank a card:

* Ranks.  ``main`` starts ``chips`` processes of ``python3 -m
  perfbench.run`` (the internal ``--rank``) before it imports anything
  heavy; it never imports torch itself.  Rank r runs the cell on
  ``cuda:r`` with torchrun's variables (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and a
  free ``MASTER_PORT``), with which the driver joins the program's process
  group; the harness joins none.  A rank that finds no ``cuda:r`` exits 3,
  and so does the run.  The driver's ``ctx`` has ``rank`` and ``world``
  (0 and 1 on one chip).
* Lockstep.  After its warm-up every rank runs ``CAL_STEPS`` steps, each
  synchronized; rank 0 divides ``--seconds`` by the median of its own and
  hands that step count to the others through a ``TCPStore`` of the
  harness's, which rank 0 holds on a port of its own.  Every rank then
  runs that many
  steps in the window (timed or traced), with no exchange on the host
  inside it, and the traffic's ``profile_steps`` in the profiled stretch.
  Rank 0's window ends in a synchronize.  ``setup_s`` runs from the
  launcher's start to rank 0's first timed step, on the host's monotonic
  clock, which every process shares.
* Merge.  The result is rank 0's metrics, steps and breakdown; each number
  compared at its worst over the ranks, and ``correct`` only where every
  rank's is.  ``device.count`` is the number of distinct cards (UUIDs) the
  ranks ran on, ``memory_peak_bytes`` the fullest card's peak beside
  ``memory_peak_bytes_by_rank``, ``power_limit_w`` the lowest card's, and
  with ``--trace 1`` rank 0's ``busy_s`` and ``window_s``, which its
  per-layer metrics read, beside ``busy_s_by_rank``.  A rank hands its
  report to the launcher in a file the launcher names, never on standard
  output, so only ``main`` prints a result.
* Refusal.  A rank that exits non-zero, or the deadline (``DEADLINE_S``
  after the launcher's start) passing, stops every rank; so do ranks that
  report fewer distinct cards than the cell asks for, cards of more than
  one kind, or different step counts.  The run then exits 5 and prints no
  result.
"""
import time

T_START = time.perf_counter()
T_SHARED = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import types  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_supplychain_tpu")
SPAN_PREFIX = "pb."
CAL_STEPS = 3
# under the 1200 s that a checkout's first run, which builds, may take
DEADLINE_S = 1140.0


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


def _power_limit(card: str):
    """The power limit in W of ``nvidia-smi``'s card ``card`` (an index or
    a UUID), or None where it gives none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", card],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _device(peak: int, cuda: bool):
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": peak}
    power = _power_limit("0")
    if power is not None:
        dev["power_limit_w"] = power
    return dev


def _card(peak: int, cuda: bool, rank: int):
    """What a rank reports of its device for the merge: its ``index``,
    ``uuid``, ``kind``, power limit and peak.  On the CPU, where only the
    tests run ranks, each rank stands for a device of its own."""
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "index": rank,
                "uuid": f"cpu-{rank}", "memory_peak_bytes": peak}
    i = torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(i).uuid)
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(i),
            "index": i, "uuid": uuid, "memory_peak_bytes": peak}
    power = _power_limit(uuid if uuid.startswith("GPU-") else "GPU-" + uuid)
    if power is not None:
        card["power_limit_w"] = power
    return card


class Lockstep:
    """A rank's place among a cell's ranks: ``rank`` of ``world``, the
    launcher's start ``t0`` (``time.monotonic``), and the harness's store
    (rank 0 holds it), through which rank 0 hands the others the window's
    step count."""

    def __init__(self, rank: int, world: int, t0: float, port: int,
                 timeout_s: float):
        from torch.distributed import TCPStore

        self.rank, self.world, self.t0 = rank, world, t0
        self.store = TCPStore("127.0.0.1", port, None, rank == 0,
                              timeout=timedelta(seconds=timeout_s),
                              wait_for_workers=False)

    def window_steps(self, step, marks, seconds: float) -> int:
        """Run ``CAL_STEPS`` synchronized steps and return the window's
        step count, the same on every rank: ``seconds`` over the median of
        rank 0's steps."""
        times = []
        for _ in range(CAL_STEPS):
            marks.sync()
            t = time.perf_counter()
            step()
            marks.sync()
            times.append(time.perf_counter() - t)
        if self.rank == 0:
            n = max(1, round(seconds / statistics.median(times)))
            self.store.set("window_steps", str(n))
            return n
        return int(self.store.get("window_steps"))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", override=None, lock=None):
    """Run the cell once on ``device`` and return its result (a dict in
    the order it is printed).  ``override`` updates the configuration's
    and the traffic's keys (``{"config": {...}, "traffic": {...}}``), for
    tests at a size the CPU holds, and its ``driver`` names a module to
    run in place of the traffic kind's.  ``lock`` (a ``Lockstep``) makes
    the run one rank of several: its window runs the step count rank 0
    fixed, and its device report is the rank's card for ``merge``."""
    import torch

    _, config, traffic, e2e, layer = load_cell(name)
    override = override or {}
    config = {**config, **override.get("config", {})}
    traffic = {**traffic, **override.get("traffic", {})}
    torch.set_num_threads(1)
    # float32 means float32: no configuration runs its matmuls in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if lock is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    driver = importlib.import_module(override.get(
        "driver", f"perfbench.drivers.{traffic['kind']}"))
    marks = Marks(device)
    spans = Spans(marks) if trace else None
    rank, world = (lock.rank, lock.world) if lock else (0, 1)
    ctx = types.SimpleNamespace(config=config, traffic=traffic,
                                seed=int(seed), device=device, spans=spans,
                                rank=rank, world=world)
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
    if lock is None:
        setup_s = time.perf_counter() - T_START
        going = lambda i: time.perf_counter() - t0 < seconds  # noqa: E731
    else:
        n = lock.window_steps(
            (lambda: cell.step_spans(Spans(marks))) if trace else cell.step,
            marks, seconds)
        setup_s = time.monotonic() - lock.t0
        going = lambda i: i < n  # noqa: E731
    metrics, extra = {}, {}
    t0 = time.perf_counter()
    if not trace:
        ends = [marks.mark()]
        while going(len(ends) - 1):
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
        while going(steps):
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
    dev = {**(_device(peak, marks.cuda) if lock is None
              else _card(peak, marks.cuda, rank)), **extra}
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


class RankFailure(RuntimeError):
    """The ranks of a cell give no result: one failed, the deadline passed,
    or their reports were refused.  ``code`` is the run's exit code: 3
    where a rank found no card, else 5."""

    def __init__(self, message: str, code: int = 5):
        super().__init__(message)
        self.code = code


def _worst(values):
    """The worst of a number's values over the ranks: the largest, and
    any that is not finite before all."""
    return max(values, key=lambda v: v if math.isfinite(v) else math.inf)


def merge(results, chips: int):
    """One result of the ranks' (rank 0's first): rank 0's metrics, steps
    and breakdown, the cards the ranks used, each number compared at its
    worst.  Raises ``RankFailure`` for fewer distinct cards than
    ``chips``, cards of more than one kind, or ranks whose step counts
    differ."""
    head, cards = results[0], [r["device"] for r in results]
    kinds = sorted({c["kind"] for c in cards})
    if len(kinds) != 1:
        raise RankFailure(f"the ranks ran on cards of {len(kinds)} kinds: "
                          f"{kinds}")
    count = len({c["uuid"] for c in cards})
    if count < chips:
        raise RankFailure(
            f"the ranks ran on {count} distinct device(s) "
            f"({[c['index'] for c in cards]}), the cell asks for {chips}")
    steps = [r["attempted"] for r in results]
    if len(set(steps)) != 1:
        raise RankFailure(f"the ranks ran different numbers of steps: "
                          f"{steps}")
    peaks = [c["memory_peak_bytes"] for c in cards]
    dev = {"platform": cards[0]["platform"], "kind": kinds[0],
           "count": count, "memory_peak_bytes": max(peaks),
           "memory_peak_bytes_by_rank": peaks}
    power = [c["power_limit_w"] for c in cards if "power_limit_w" in c]
    if power:
        dev["power_limit_w"] = min(power)
    if "busy_s" in head["device"]:
        dev["busy_s"] = head["device"]["busy_s"]
        dev["window_s"] = head["device"]["window_s"]
        dev["busy_s_by_rank"] = [c["busy_s"] for c in cards]
    out = {"correct": all(r["correct"] for r in results),
           "attempted": head["attempted"],
           "failed": head["failed"],
           "metrics": head["metrics"], "device": dev}
    if "breakdown" in head:
        out["breakdown"] = head["breakdown"]
    out["checks"] = {k: {"value": _worst(r["checks"][k]["value"]
                                         for r in results),
                         "limit": c["limit"]}
                     for k, c in head["checks"].items()}
    return out


def _free_ports(n: int):
    """``n`` distinct free ports of 127.0.0.1: every socket is bound
    before any is closed.  Another process may still take one before its
    rank binds it; the rank then fails, and so does the run."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _wait(procs, deadline: float):
    """None once every rank has exited 0; else the ``RankFailure`` that
    stopped the run: the first rank to exit non-zero, or the deadline."""
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0):
                return RankFailure(f"rank {r} exited {c}", 3 if c == 3 else 5)
        if all(c == 0 for c in codes):
            return None
        if time.monotonic() > deadline:
            return RankFailure(
                f"the deadline passed with ranks "
                f"{[r for r, c in enumerate(codes) if c is None]} running")
        time.sleep(0.05)


def _stop(procs):
    """End each rank's process group (the rank and whatever it started)
    and wait for the ranks."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for p in procs:
        p.wait()


def launch(name: str, seed: int, seconds: float, trace: bool, chips: int,
           device: str = "cuda", override=None,
           deadline_s: float = DEADLINE_S, t0=None):
    """Run the cell on ``chips`` ranks, rank r on ``cuda:r`` (every rank
    on the CPU where ``device`` is ``"cpu"``, for tests), all under one
    deadline ``deadline_s`` after ``t0`` (``time.monotonic``; by default
    now), and return ``merge`` of their results.  Raises ``RankFailure``
    where there is none; no rank is left running either way."""
    t0 = time.monotonic() if t0 is None else t0
    (store_port, group_port), procs = _free_ports(2), []
    with tempfile.TemporaryDirectory(prefix="perfbench-ranks-") as tmp:
        logs = [(Path(tmp, f"rank{r}.json"), Path(tmp, f"rank{r}.log"))
                for r in range(chips)]
        try:
            for r, (out, err) in enumerate(logs):
                spec = {"rank": r, "world": chips, "t0": t0,
                        "store": store_port, "timeout": deadline_s,
                        "device": f"cuda:{r}" if device == "cuda" else device,
                        "override": override, "report": str(out)}
                env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(chips),
                       "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(chips),
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(group_port)}
                with open(err, "wb") as fe:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "perfbench.run", "--workload",
                         name, "--seed", str(int(seed)), "--seconds",
                         repr(float(seconds)), "--trace", str(int(trace)),
                         "--rank", json.dumps(spec)],
                        cwd=ROOT, env=env, stdout=fe,
                        stderr=subprocess.STDOUT,
                        start_new_session=True))
            failure = _wait(procs, t0 + deadline_s)
        finally:
            _stop(procs)
            for r, (_, err) in enumerate(logs):
                if err.exists():
                    for ln in err.read_text(errors="replace").splitlines():
                        print(f"[rank {r}] {ln}", file=sys.stderr)
        if failure:
            raise failure
        results = []
        for r, (out, _) in enumerate(logs):
            if not out.exists():
                raise RankFailure(f"rank {r} gave no report")
            results.append(json.loads(out.read_text()))
    return merge(results, chips)


def _exit_with_parent():
    """End this rank if the launcher that started it ends first."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(6)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(args) -> int:
    """One rank of a cell on several cards (``launch`` starts it)."""
    import torch

    spec = args.rank
    dev = torch.device(spec["device"])
    if dev.type == "cuda" and not dev.index < torch.cuda.device_count():
        print(f"rank {spec['rank']}: no CUDA device {dev} "
              f"({torch.cuda.device_count()} found): the benchmark measures "
              "the card", file=sys.stderr)
        return 3
    _exit_with_parent()
    lock = Lockstep(spec["rank"], spec["world"], spec["t0"], spec["store"],
                    spec["timeout"])
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), spec["device"], spec["override"],
                      lock)
    found = loaded_forbidden()
    if found:
        print(f"loaded in rank {spec['rank']}: {', '.join(found)}",
              file=sys.stderr)
        return 4
    Path(spec["report"]).write_text(json.dumps(result))
    return 0


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
    # internal: a rank's part, which ``launch`` passes
    p.add_argument("--rank", type=json.loads, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    wl = load_cell(args.workload)[0]
    chips = int(wl["chips"])
    if chips > 1:
        try:
            result = launch(args.workload, args.seed, args.seconds,
                            bool(args.trace), chips, t0=T_SHARED)
        except RankFailure as e:
            print(f"no result: {e}", file=sys.stderr)
            return e.code
    else:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < chips:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                  f"for {chips}", file=sys.stderr)
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
