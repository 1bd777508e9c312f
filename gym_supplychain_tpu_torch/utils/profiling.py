"""The port's spans and counters, device traces, a steps/s meter and JSONL
metric lines (the counterpart of ``gym_supplychain_tpu/utils/profiling.py``).

Spans mark the layer boundaries of the trainers, the evaluator, the table
draw, the ``ops/*`` wrappers and the mesh's all-reduces: ``with
span("ppo.gae"):``.  One switch,
``enable(on)``, turns them on; off (the default) ``span`` hands back one
shared no-op object, so an off span costs a flag test: no
``record_function``, no clock, no allocation.  On, a span enters
``torch.profiler.record_function("gsc." + name)``, so it lands in a running
``torch.profiler`` trace (a ``user_annotation`` event) on the timeline of
the device operations launched inside it, and keeps a record of its name,
its parent (the enclosing open span) and its host start and end
(``time.perf_counter_ns``) in memory, up to ``MAX_SPANS`` records, the
oldest dropped first (the counter ``spans.dropped`` counts them);
``take()`` hands the records over and clears them.  No span synchronizes
the device.

Counters are always on: ``count(name, n)`` adds to one integer registry,
``counters()`` reads it and ``reset_counters()`` clears it.  The kernels'
launchers count their launches there (``launch.<kernel>``), the
wrappers their weight packs (``ops.pack``, and ``ops.pack_reused`` where
the greedy runner reuses its last pack), and ``parallel/mesh.py`` the
collectives over a mesh's data and model groups (``collective.data``,
``collective.model``) and the bytes each rank hands them
(``collective.data_bytes``, ``collective.model_bytes``).

``trace(logdir)`` records the CPU and, where there is a card, the CUDA
activity of its block with ``torch.profiler``, with the spans on, and
writes a Chrome trace a rank (``trace.rank<r>.json``, viewable in Perfetto
or chrome://tracing); ``kernel_busy_share`` reads one back: the card's busy
time as the union of its kernels' intervals, over the traced window.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from time import perf_counter_ns
from typing import NamedTuple, Optional

from torch.profiler import record_function

__all__ = ["span", "enable", "enabled", "take", "SpanRecord", "MAX_SPANS",
           "count", "counters", "reset_counters", "trace",
           "kernel_busy_share", "Throughput", "log_metrics"]

SPAN_PREFIX = "gsc."
MAX_SPANS = 1 << 16       # span records kept between two take() calls


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]     # the span open around it, None at the top
    start_ns: int             # perf_counter_ns() on entry
    end_ns: int               # and on exit


_on = False
_open = []                    # names of the spans open now, innermost last
_records = collections.deque()
_counts = collections.Counter()


_OFF = contextlib.nullcontext()    # what ``span`` hands back while off


class _Span:
    __slots__ = ("name", "parent", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self.name)
        self.rf = record_function(SPAN_PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        self.rf.__exit__(*exc)
        _open.pop()
        if len(_records) >= MAX_SPANS:
            _records.popleft()
            _counts["spans.dropped"] += 1
        _records.append(SpanRecord(self.name, self.parent, self.t0, t1))
        return False


def span(name: str):
    """A context manager marking a layer boundary ``name`` (the module
    docstring); the shared no-op while the spans are off."""
    return _Span(name) if _on else _OFF


def enable(on: bool = True) -> bool:
    """Turn the spans on or off; returns whether they were on."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    """Whether the spans are on."""
    return _on


def take() -> list:
    """The span records kept since the last call (``SpanRecord``s in the
    order the spans closed), clearing them."""
    out = list(_records)
    _records.clear()
    return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> dict:
    """Every counter's value, ``{name: int}`` (a copy)."""
    return dict(_counts)


def reset_counters() -> None:
    """Set every counter back to nothing."""
    _counts.clear()


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is available), the spans on, into
    ``<logdir>/trace.rank<r>.json``, r the process group's rank (0 outside
    one).  A no-op for a falsy ``logdir``.  Yields the profiler (None when
    off)."""
    if not logdir:
        yield None
        return
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    rank = (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = enable(True)
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(logdir, f"trace.rank{rank}.json"))


def kernel_busy_share(path: str) -> dict:
    """The card's busy share of a Chrome trace written by ``trace``: the
    union of the kernels' intervals (events of category ``kernel``) over
    the traced window (the first event's start to the last one's end, host
    events included).  Returns ``{"kernels", "busy_ms", "window_ms",
    "share"}``."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events,
                                                            dict) else events
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X" and "ts" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("ph") == "X"
                     and e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    for a, b in kernels:          # the union of the intervals, in order
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0.0)
    return {"kernels": len(kernels), "busy_ms": busy / 1e3,
            "window_ms": window / 1e3,
            "share": busy / window if window > 0 else 0.0}


class Throughput:
    """env-steps/s meter over a sliding window."""

    def __init__(self, batch_size: int):
        self.B = batch_size
        self.t0 = time.perf_counter()
        self.steps = 0

    def update(self, n_steps: int = 1) -> float:
        self.steps += n_steps
        dt = time.perf_counter() - self.t0
        return self.B * self.steps / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0


def log_metrics(step: int, metrics: dict, stream=None):
    """One JSONL metrics line per call."""
    if stream is None:
        stream = sys.stdout      # late-bound: respects redirection/capture
    row = {"step": step}
    for k, v in metrics.items():
        try:
            row[k] = float(v)
        except (TypeError, ValueError):
            row[k] = v
    stream.write(json.dumps(row) + "\n")
    stream.flush()
