"""The lane-group kernel collecting an episode of random actions (K1
random: every obs and reward out), over the collect span's device time.
Percent of the bound (perfbench/counts.py)."""
from perfbench.metrics._roofline import share


def read(run):
    return share(run, "collect")
