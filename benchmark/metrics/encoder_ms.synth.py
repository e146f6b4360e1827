"""Device time of the linguistic encoder a call: the ops launched inside
the program's `model.encoder` span (`benchmark/spans.py`), over the
profiled calls.  Layer: acoustic model.  Moves utt_per_s."""

import importlib


def read(r):
    return importlib.import_module("benchmark.spans").per_call_ms(r, ("model.encoder",))
