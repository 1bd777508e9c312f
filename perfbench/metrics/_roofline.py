"""A span's share of its bound: the bound of a step's work in that span
(``perfbench/counts.py``) over the device time of the operations launched
inside the span a step, in percent; nothing where the trace holds none."""


def share(run, span):
    bound_ms = run.shape.get("bound_ms", {}).get(span)
    device_s = run.kernel_s.get(span)
    if not bound_ms or not device_s:
        return None
    return 100.0 * bound_ms / (1e3 * device_s / run.profiled_steps)
