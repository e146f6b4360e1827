"""Device time of the acoustic model a call (CUDA events at the model's
forward pre- and post-hooks), mean over the traced run's calls outside the
profiled stretch.  Layer: acoustic model.  Moves utt_per_s."""


def read(r):
    if r.data is None or r.data["kind"] != "synth" or not r.data["acoustic_ms"]:
        return None
    return sum(r.data["acoustic_ms"]) / len(r.data["acoustic_ms"])
