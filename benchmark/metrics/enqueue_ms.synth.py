"""Host time of `TTSPipeline.submit` (enqueueing the call's device work),
mean over the traced run's calls outside the profiled stretch (host
clock).  Layer: serving pipeline.  Moves synth_p95_ms."""


def read(r):
    if r.data is None or r.data["kind"] != "synth" or not r.data["enqueue_ms"]:
        return None
    return sum(r.data["enqueue_ms"]) / len(r.data["enqueue_ms"])
