"""Device kernels a training step launches: the kernels in the profiled
chunk over its steps.  Layer: train step.  Moves train_frames_per_s."""


def read(r):
    if r.data is None or r.data["kind"] != "train" or r.profile is None:
        return None
    return len(r.profile.kernels()) / r.data["steps_profiled"]
