"""Device time of one reverse step of the diffusion decoder, in ms: the
profiled stretch's denoiser kernels (the names `denoiser_roofline` reads)
in stream order, split into as many equal groups as the program's
`diffusion.step` spans, one group a step; within each call (its steps: the
`diffusion.step` spans over the `model.diffusion` spans) the time from the
end of one step's last kernel to the end of the next step's, mean over the
stretch.  That interval holds one whole step's device work (the
denoiser's projections and kernel, the clamp, the posterior sample) and
any idle in it, and needs no pairing of device ops with their launches
(`benchmark/spans.py`).  None outside a traced synthesis run, without the
spans, where a call runs one step, or where the kernels do not split
evenly.  Layer: acoustic model.  Moves utt_per_s."""

KERNELS = ("residual_stack_mma", "wide_conv_gate", "wide_out_proj")   # csrc/denoiser_stack.cu


def read(r):
    if r.data is None or r.data["kind"] != "synth" or r.profile is None:
        return None
    count = {"diffusion.step": 0, "model.diffusion": 0}
    for _, _, name, annotation in r.profile.host:
        if annotation and name in count:
            count[name] += 1
    steps, calls = count["diffusion.step"], count["model.diffusion"]
    if not calls or steps % calls or steps // calls < 2:
        return None
    ends = [e for _, e, name, _ in r.profile.kernels() if any(k in name for k in KERNELS)]
    if not ends or len(ends) % steps:
        return None
    per_step, per_call = len(ends) // steps, steps // calls
    last = ends[per_step - 1::per_step]   # the end of each step's last kernel
    intervals = [last[c * per_call + k + 1] - last[c * per_call + k]
                 for c in range(calls) for k in range(per_call - 1)]
    return 1e-6 * sum(intervals) / len(intervals)
