"""WAV IO (`mixgantts_tpu/audio/wav.py`), with scipy: `load_wav` matches
`librosa.load(path, sr)` (mono float32 in [-1, 1], resampled with a
polyphase filter); `save_wav` writes int16."""

from math import gcd

import numpy as np
from scipy.io import wavfile


def load_wav(path, sr=22050):
    """Read a wav file as mono float32 in [-1, 1] at the requested rate."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr is not None and file_sr != sr:
        from scipy.signal import resample_poly   # slow to import: only where a file needs it
        g = gcd(int(sr), int(file_sr))
        wav = resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
    return wav, (sr or file_sr)


def save_wav(path, wav, sr, max_wav_value=32768.0):
    """Write float or int16 samples as an int16 wav."""
    wav = np.asarray(wav)
    if wav.dtype != np.int16:
        peak = np.max(np.abs(wav)) + 1e-9
        if peak > 1.5:  # already int16-scaled floats
            wav = np.clip(wav, -max_wav_value, max_wav_value - 1)
        else:
            wav = np.clip(wav, -1.0, 1.0) * (max_wav_value - 1)
        wav = wav.astype(np.int16)
    wavfile.write(path, sr, wav)
