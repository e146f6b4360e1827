"""(A copy of `mixgantts_tpu/audio/mel.py`.) Slaney-style mel filterbank,
numerically equivalent to `librosa.filters.mel(sr, n_fft, n_mels, fmin,
fmax)` with its defaults (htk=False, norm='slaney') — the basis the
reference's TacotronSTFT uses (`audio/stft.py:151-155`). librosa is not a
dependency, so the filterbank is derived here from the
published Slaney formulas."""

import numpy as np

_F_SP = 200.0 / 3            # linear region: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(log_region,
                   _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ)
                   / _LOGSTEP,
                   mel)
    return mel


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    f)


def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """[n_mels, 1 + n_fft//2] triangular filters with Slaney normalization."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization: each filter integrates to ~constant
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
