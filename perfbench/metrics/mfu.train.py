"""The whole iteration's share of the card's float32 peak: the model
operations a step (the rollout's actor and critic forward and the update
kernel's calls) times the steps of the traced window
before the profiled stretch, over that window's seconds times 67
TFLOP/s (TF32 off), in percent."""
from perfbench.counts import PEAK_FLOPS


def read(run):
    flops = run.shape.get("flops")
    if not flops or run.window_total_s <= 0:
        return None
    return 100.0 * flops * run.steps / (run.window_total_s * PEAK_FLOPS)
