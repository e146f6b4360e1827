"""Device time of HiFi-GAN's upsampling a call: the ops launched inside
the program's `vocoder.upsample` spans (leaky ReLU and the transposed
convolution of each stage; `benchmark/spans.py`), over the profiled calls.
Layer: vocoder.  Moves utt_per_s."""

import importlib


def read(r):
    return importlib.import_module("benchmark.spans").per_call_ms(r, ("vocoder.upsample",))
