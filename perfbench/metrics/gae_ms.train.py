"""GAE, the advantages' normalization and the update layout an iteration
(the trainer's ``prepare``): the median over the traced window of the
``prepare`` span, between CUDA events."""
import statistics


def read(run):
    ms = run.spans.get("prepare")
    return statistics.median(ms) if ms else None
