"""The evaluator's Philox table draw a call (the ``draw_tables`` hook of
``make_fused_evaluator``): the median over the traced window of the
``draw`` span, between CUDA events."""
import statistics


def read(run):
    ms = run.spans.get("draw")
    return statistics.median(ms) if ms else None
