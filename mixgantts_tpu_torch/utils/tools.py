"""Small helpers (`mixgantts_tpu/utils/tools.py`): host-side padding,
word subdivision and expansion (numpy), the length buckets, and the device
rule of the port's entry points."""

import numpy as np
import torch


def word_level_subdivision(phones_per_word, max_phoneme_num):
    """Split words longer than max_phoneme_num into chunks."""
    res = []
    for n in phones_per_word:
        if n <= max_phoneme_num:
            res.append(int(n))
        else:
            s, r = divmod(int(n), max_phoneme_num)
            res += [max_phoneme_num] * s + ([r] if r else [])
    return res


def pad_1d(inputs, length=None, pad_value=0):
    """Stack 1D arrays padded to a common (or given) length."""
    length = length or max(len(x) for x in inputs)
    return np.stack([
        np.pad(np.asarray(x), (0, length - len(x)), constant_values=pad_value)
        for x in inputs])


def pad_2d(inputs, length=None):
    """Stack [T_i, D] arrays padded on the time axis."""
    length = length or max(np.shape(x)[0] for x in inputs)
    return np.stack([
        np.pad(np.asarray(x), ((0, length - np.shape(x)[0]), (0, 0)))
        for x in inputs])


def pad_3d(inputs, B, T, L):
    """Place [t_i, l_i] arrays into a zero [B, T, L] box."""
    out = np.zeros((B, T, L), dtype=np.float32)
    for i, x in enumerate(inputs):
        x = np.asarray(x)
        out[i, :x.shape[0], :x.shape[1]] = x
    return out


def expand(values, durations):
    """Repeat each value by its duration (host-side logging helper)."""
    out = []
    for value, d in zip(values, durations):
        out += [value] * max(0, int(d))
    return np.array(out)


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
