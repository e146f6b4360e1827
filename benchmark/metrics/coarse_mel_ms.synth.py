"""Device time of the coarse mel a call: the ops launched inside the
program's `model.decoder` (the FFT decoder and mel_linear) and
`model.postnet` spans (`benchmark/spans.py`), the float32 cuDNN
convolutions among them, over the profiled calls.  Layer: acoustic model.
Moves utt_per_s."""

import importlib


def read(r):
    return importlib.import_module("benchmark.spans").per_call_ms(
        r, ("model.decoder", "model.postnet"))
