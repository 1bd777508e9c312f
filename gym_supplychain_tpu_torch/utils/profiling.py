"""A steps/s meter and JSONL metric lines (the counterpart of
``gym_supplychain_tpu/utils/profiling.py``'s ``Throughput`` and
``log_metrics``; device traces are not ported yet)."""
from __future__ import annotations

import json
import sys
import time

__all__ = ["Throughput", "log_metrics"]


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
