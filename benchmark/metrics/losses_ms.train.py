"""Device time of the losses a training step: the ops launched inside the
program's `train.losses` spans (D's loss, G's adversarial and
reconstruction losses; `benchmark/spans.py`), over the profiled chunk's
steps.  Layer: train step.  Moves train_frames_per_s."""

import importlib


def read(r):
    return importlib.import_module("benchmark.spans").per_step_ms(r, ("train.losses",))
