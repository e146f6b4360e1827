"""The whole synthesis call's share of the chip's peak, in %: the least
time of the call's work (FLOP counted on the reference at the call's
shape, the kernels' bf16 operands at 989 TFLOP/s and the rest, float32, at
67 TFLOP/s: `work.counts.synth_flops`) summed over the traced run's calls
outside the profiled stretch, over their host-clock time.  Layer: whole
call.  Moves utt_per_s."""


def read(r):
    if r.data is None or r.data["kind"] != "synth" or not r.data["outside"]:
        return None
    least = sum(r.data["work"][r.data["shapes"][j]]["least_s"] for j in r.data["outside"])
    return 100.0 * least / sum(r.data["call_s"])
