"""The policy lane kernel collecting an episode of every lane (K1 policy:
the actor and critic forward a sample, the obs, action, log-prob, value
and reward out), over the collect span's device time. Percent of the
bound (perfbench/counts.py)."""
from perfbench.metrics._roofline import share


def read(run):
    return share(run, "collect")
