"""Device time of the optimizer updates a training step: the ops launched
inside the program's `train.update` spans (D's and G's gradient clipping
and Adam; `benchmark/spans.py`), over the profiled chunk's steps.  Layer:
train step.  Moves train_frames_per_s."""

import importlib


def read(r):
    return importlib.import_module("benchmark.spans").per_step_ms(r, ("train.update",))
