"""Reading a Chrome trace of ``torch.profiler``: the device's busy time,
each device operation's benchmark span, and the breakdown.

The benchmark marks its spans on the host with ``record_function`` (events
of category ``user_annotation``).  A device operation (categories
``kernel``, ``gpu_memcpy``, ``gpu_memset``) belongs to the span that was
open on the host when it was launched: its ``correlation`` id names the
runtime or driver call that launched it, and that call's start lies in the
innermost span around it.  Attributing by span, not by kernel name, keeps a
layer's count valid when a later change replaces the kernel under it.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

__all__ = ["load", "device_ops", "busy_us", "attribute", "breakdown"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"


def load(path):
    with open(path) as fh:
        data = json.load(fh)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats
            and "ts" in e]


def device_ops(events):
    """``[(start us, end us, name, correlation or None)]`` in start order."""
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e.get("name", "?"), (e.get("args") or {}).get("correlation"))
           for e in _complete(events, DEVICE_CATS)]
    return sorted(ops)


def _union(intervals):
    """The merged, ordered intervals of ``[(a, b)]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(events):
    """Microseconds in which a device operation ran: the union of their
    intervals."""
    return sum(b - a for a, b in _union([(a, b) for a, b, _, _ in
                                         device_ops(events)]))


def _spans(events, names):
    """The benchmark's host spans ``[(start, end, name)]`` named in
    ``names``, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["name"]) for e in _complete(events, (SPAN_CAT,))
                  if e.get("name") in names)


def _innermost(spans, t):
    """The name of the innermost span of ``spans`` open at ``t``."""
    best = None
    for a, b, name in spans:
        if a > t:
            break
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name)
    return None if best is None else best[1]


def attribute(events, names):
    """Device seconds of the operations launched inside each span of
    ``names`` (innermost), ``{name: seconds}``; operations launched outside
    every span, or whose launch the trace lacks, go under ``None``."""
    spans = _spans(events, names)
    launched = {(e.get("args") or {}).get("correlation"): float(e["ts"])
                for e in _complete(events, LAUNCH_CATS)}
    out = defaultdict(float)
    for a, b, _, corr in device_ops(events):
        t = launched.get(corr)
        out[None if t is None else _innermost(spans, t)] += (b - a) / 1e6
    return dict(out)


def breakdown(events, names, top: int = 10):
    """``{"device_ops": [[name, seconds]], "idle_gaps": [[span, seconds]]}``:
    the device operations that took most time, summed by name, and the
    device's idle time between its first and last operation summed by the
    benchmark span open on the host where each gap began (``outside``
    where none was), at most ``top`` entries each."""
    ops = device_ops(events)
    by_name = defaultdict(float)
    for a, b, name, _ in ops:
        by_name[name] += (b - a) / 1e6
    spans = _spans(events, names)
    starts = [a for a, _, _ in spans]
    idle = defaultdict(float)
    merged = _union([(a, b) for a, b, _, _ in ops])
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, end)
        where = _innermost(spans[:i], end) or "outside"
        idle[where] += (nxt - end) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}
