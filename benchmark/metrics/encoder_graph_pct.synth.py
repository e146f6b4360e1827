"""Share of the profiled stretch's linguistic encoder calls that replayed
the encoder's CUDA graph, in %: the program's `model.encoder` spans that
hold an `encoder.replay` span, over all its `model.encoder` spans.  None
where the profile holds no `model.encoder` span.  Layer: acoustic model.
Moves utt_per_s."""


def read(r):
    if r.data is None or r.data["kind"] != "synth" or r.profile is None:
        return None
    spans = {"model.encoder": [], "encoder.replay": []}
    for s, e, name, annotation in r.profile.host:
        if annotation and name in spans:
            spans[name].append((s, e))
    calls = spans["model.encoder"]
    if not calls:
        return None
    replayed = sum(any(s <= rs and re <= e for rs, re in spans["encoder.replay"])
                   for s, e in calls)
    return 100.0 * replayed / len(calls)
