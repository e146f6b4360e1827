"""Device time around the MRF kernels a call: the ops launched inside the
program's `vocoder.mrf` spans but outside every kernel entry's `kernel.*`
span (the stage's transposes, copies to a contiguous layout and branch
sums; `benchmark/spans.py`), over the profiled calls.  Layer: MRF kernels.
Moves utt_per_s."""

import importlib

KERNEL_ENTRIES = ("kernel.mrf_stack", "kernel.mrf_stack_folded", "kernel.mrf_stack_streamed",
                  "kernel.narrow_stage", "kernel.fused_residual_stack")


def read(r):
    return importlib.import_module("benchmark.spans").per_call_ms(
        r, ("vocoder.mrf",), exclude=KERNEL_ENTRIES)
