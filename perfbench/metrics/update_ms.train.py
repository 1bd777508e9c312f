"""The update loop's time an iteration (``learn/ppo.py::_make_update``: the
update kernel, the clip, Adam): the median over the traced window of the
``update`` span, between CUDA events."""
import statistics


def read(run):
    ms = run.spans.get("update")
    return statistics.median(ms) if ms else None
