"""The greedy episode kernel (K4: the tables and the actor in, the rewards
out, the actor's forward a step), over the device time of the evaluate
span's own operations (the table draw apart). Percent of the bound
(perfbench/counts.py)."""
from perfbench.metrics._roofline import share


def read(run):
    return share(run, "evaluate")
