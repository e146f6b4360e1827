"""Device time of the vocoder a call (CUDA events at the HiFi-GAN
generator's forward pre- and post-hooks), mean over the traced run's calls
outside the profiled stretch.  Layer: vocoder.  Moves utt_per_s."""


def read(r):
    if r.data is None or r.data["kind"] != "synth" or not r.data["vocoder_ms"]:
        return None
    return sum(r.data["vocoder_ms"]) / len(r.data["vocoder_ms"])
