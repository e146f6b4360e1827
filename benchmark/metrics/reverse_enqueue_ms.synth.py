"""Host time of one reverse step of the diffusion decoder, in ms: the mean
duration of the program's `diffusion.step` spans in the profiled stretch
(the host's enqueue of the denoiser, the clamp and the posterior sample).
Beside `reverse_step_ms.synth` it says whether the reverse loop is paced by
the host or by the card.  None outside a traced synthesis run or without
the spans.  Layer: acoustic model.  Moves utt_per_s."""


def read(r):
    if r.data is None or r.data["kind"] != "synth" or r.profile is None:
        return None
    spans = [e - s for s, e, name, annotation in r.profile.host
             if annotation and name == "diffusion.step"]
    return 1e-6 * sum(spans) / len(spans) if spans else None
