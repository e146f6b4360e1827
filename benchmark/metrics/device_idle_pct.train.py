"""Share of the profiled chunk of a training run in which no kernel, copy
or set ran on the device, in %: 100 (1 - busy / window).  Layer: device.
Moves train_frames_per_s."""


def read(r):
    if r.data is None or r.data["kind"] != "train" or r.profile is None:
        return None
    return 100.0 * (1.0 - r.profile.busy_s / r.profile.window_s)
