"""The update kernel's calls of an iteration (the forward, the weight and
input gradients, an epoch a call), over the update span's device time
(with the clip and Adam). Percent of the bound (perfbench/counts.py)."""
from perfbench.metrics._roofline import share


def read(run):
    return share(run, "update")
