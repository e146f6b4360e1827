"""Small helpers: the length buckets (`mixgantts_tpu/utils/tools.py`) and
the device rule of the port's entry points."""

import torch


def bucket_length(n, buckets):
    """Smallest bucket >= n (falls back to n itself past the largest)."""
    for b in buckets:
        if n <= b:
            return b
    return n


def resolve_device(device=None):
    """The device an entry point runs on: `cuda` unless the caller names
    another.  Raises when CUDA is asked for (or implied) and absent, so a
    machine without a GPU never falls back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
