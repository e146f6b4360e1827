"""The MRF kernels' share of their roofline, in %: the least time of every
MRF stage's work (`work.counts.mrf_work` at the stage's shape, bf16
weights, against the bf16 peak and HBM bandwidth) summed over the profiled
calls, over the device time of the kernels named below in the profile.
Layer: MRF kernels.  Moves utt_per_s."""

import importlib

KERNELS = ("mrf_pair_mma", "mrf_wide_mma", "mrf_stage_narrow",
           "mrf_stage_streamed")   # csrc/mrf_stack.cu, mrf_stage_narrow.cu, mrf_stack_streamed.cu


def read(r):
    if r.data is None or r.data["kind"] != "synth" or r.profile is None:
        return None
    counts = importlib.import_module("benchmark.work.counts")
    device_s = r.profile.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    least = sum(counts.least_s(f, b, counts.PEAK_BF16)
                for j in r.data["profiled"] for f, b in r.data["work"][r.data["shapes"][j]]["mrf"])
    return 100.0 * least / device_s
