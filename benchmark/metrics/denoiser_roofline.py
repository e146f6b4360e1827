"""The denoiser kernel's share of its roofline, in %: the least time of
its work (`work.counts.denoiser_work` without the hoisted projections, at
the call's shape, bf16 weights, against the bf16 peak and HBM bandwidth)
summed over the profiled calls, over the device time of the kernels named
below in the profile.  Layer: denoiser kernel.  Moves utt_per_s."""

import importlib

KERNELS = ("residual_stack_mma", "wide_conv_gate", "wide_out_proj")   # csrc/denoiser_stack.cu


def read(r):
    if r.data is None or r.data["kind"] != "synth" or r.profile is None:
        return None
    counts = importlib.import_module("benchmark.work.counts")
    device_s = r.profile.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    least = sum(counts.least_s(*r.data["work"][r.data["shapes"][j]]["denoiser"], counts.PEAK_BF16)
                for j in r.data["profiled"])
    return 100.0 * least / device_s
