"""WAV output (`mixgantts_tpu/audio/wav.py::save_wav`), with scipy."""

import numpy as np
from scipy.io import wavfile


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
