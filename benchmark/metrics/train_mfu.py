"""The whole training step's share of the chip's peak, in %: the FLOP of
one step counted on the reference's step at the cell's shapes
(`torch.utils.flop_counter`, forward and backward, all float32) at 67
TFLOP/s, over the mean host-clock time of a step in the traced run's
chunks outside the profiled one.  Layer: whole step.  Moves
train_frames_per_s."""

import importlib


def read(r):
    if r.data is None or r.data["kind"] != "train" or not r.data["step_s"] or not r.data["step_flops"]:
        return None
    counts = importlib.import_module("benchmark.work.counts")
    step_s = sum(r.data["step_s"]) / len(r.data["step_s"])
    return 100.0 * r.data["step_flops"] / counts.PEAK_FP32 / step_s
