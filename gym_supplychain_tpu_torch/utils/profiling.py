"""Device traces, a steps/s meter and JSONL metric lines (the counterpart
of ``gym_supplychain_tpu/utils/profiling.py``).

``trace(logdir)`` records the CPU and, where there is a card, the CUDA
activity of its block with ``torch.profiler`` and writes a Chrome trace a
rank (``trace.rank<r>.json``, viewable in Perfetto or chrome://tracing);
``kernel_busy_share`` reads one back: the card's busy time as the union of
its kernels' intervals, over the traced window.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

__all__ = ["trace", "kernel_busy_share", "Throughput", "log_metrics"]


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is available) into ``<logdir>/trace.rank<r>.json``, r the
    process group's rank (0 outside one).  A no-op for a falsy ``logdir``.
    Yields the profiler (None when off)."""
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
    with profile(activities=acts) as prof:
        yield prof
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
