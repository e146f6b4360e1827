"""Mel spectrogram (`mixgantts_tpu/audio/stft.py`).

Parity with the reference's conv-based TacotronSTFT (`audio/stft.py:15-178`):
reflect padding of n_fft/2 on both sides, periodic Hann window, magnitude
spectrum, Slaney mel basis, log dynamic-range compression with clip 1e-5
(`audio/audio_processing.py:85-91`), and frame energy = L2 norm of the
magnitude spectrum.  `mel_spectrogram` is the batched device path, in torch
(`torch.fft.rfft` of the framed signal; the JAX package's XLA path);
`get_mel_from_wav`, `griffin_lim` and `inv_mel_spec` are host numpy, as
there.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tools import resolve_device
from .mel import mel_filterbank


def hann_window(win_length, n_fft):
    """Periodic (fftbins) Hann window zero-padded to n_fft, matching
    `scipy.signal.get_window('hann', win, fftbins=True)` + pad_center."""
    n = np.arange(win_length)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    pad = n_fft - win_length
    lpad = pad // 2
    return np.pad(win, (lpad, pad - lpad)).astype(np.float32)


class TacotronSTFT:
    """Drop-in equivalent of the reference TacotronSTFT
    (`audio/stft.py:130-178`): `mel_spectrogram(y)` -> (mel [B, n_mels, F],
    energy [B, F]) for y in [-1, 1].  `device` is where `mel_spectrogram`
    puts a numpy input (cuda unless the caller names another); a tensor
    stays on its own device."""

    def __init__(self, filter_length, hop_length, win_length, n_mel_channels,
                 sampling_rate, mel_fmin=0.0, mel_fmax=None, device=None):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        self.mel_fmin = mel_fmin
        self.mel_fmax = mel_fmax
        self.device = device

    def mel_spectrogram(self, y):
        """y [B, T] or [T] (a tensor, or an array put on `device`) ->
        (log mel [B, n_mels, F], energy [B, F]), fp32."""
        if not isinstance(y, torch.Tensor):
            y = torch.as_tensor(np.asarray(y), device=resolve_device(self.device))
        y = y.float()
        if y.ndim == 1:
            y = y[None]
        n_fft, hop = self.filter_length, self.hop_length
        pad = n_fft // 2
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = y.unfold(-1, n_fft, hop)                          # [B, F, n_fft]
        win = torch.from_numpy(hann_window(self.win_length, n_fft)).to(y.device)
        magnitude = torch.fft.rfft(frames * win, dim=-1).abs()     # [B, F, n_fft//2+1]
        basis = torch.from_numpy(mel_filterbank(self.sampling_rate, n_fft, self.n_mel_channels,
                                                0.0, self.mel_fmax)).to(y.device)
        mel = torch.log(torch.clamp(torch.einsum("mf,btf->bmt", basis, magnitude), min=1e-5))
        energy = torch.linalg.vector_norm(magnitude, dim=-1)
        return mel, energy

    def get_mel_from_wav(self, audio):
        """Single-utterance numpy helper (`audio/tools.py:8-15`), on the
        host as in the JAX package, whose preprocessing uses it (so the
        artifacts equal JAX's); `mel_spectrogram` is the device path."""
        y = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
        n_fft, hop = self.filter_length, self.hop_length
        pad = n_fft // 2
        yp = np.pad(y, pad, mode="reflect")
        n_frames = 1 + (len(yp) - n_fft) // hop
        idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)
        win = hann_window(self.win_length, n_fft)
        spec = np.fft.rfft(yp[idx] * win, axis=-1)
        magnitude = np.abs(spec)                       # [F, n_fft//2+1]
        basis = mel_filterbank(self.sampling_rate, n_fft,
                               self.n_mel_channels, 0.0, self.mel_fmax)
        mel = np.log(np.clip(magnitude @ basis.T, 1e-5, None)).T
        energy = np.linalg.norm(magnitude, axis=-1)
        return mel.astype(np.float32), energy.astype(np.float32)

    # --- inversion (Griffin-Lim) for the reference's inv_mel_spec path -----

    def _linear_from_mel(self, mel):
        basis = mel_filterbank(self.sampling_rate, self.filter_length,
                               self.n_mel_channels, 0.0, self.mel_fmax)
        inv_basis = np.linalg.pinv(basis)
        return np.maximum(1e-10, inv_basis @ np.exp(np.asarray(mel)))

    def griffin_lim(self, magnitude, n_iters=30, seed=0):
        """Phase reconstruction from a [n_freq, F] magnitude (numpy)."""
        rng = np.random.RandomState(seed)
        angles = np.exp(2j * np.pi * rng.rand(*magnitude.shape))
        win = hann_window(self.win_length, self.filter_length)
        n_fft, hop = self.filter_length, self.hop_length

        def istft(stft_matrix):
            frames = np.fft.irfft(stft_matrix.T, n=n_fft, axis=-1) * win
            T = (stft_matrix.shape[1] - 1) * hop + n_fft
            y = np.zeros(T)
            wsum = np.zeros(T)
            for i, frame in enumerate(frames):
                y[i * hop:i * hop + n_fft] += frame
                wsum[i * hop:i * hop + n_fft] += win ** 2
            y[wsum > 1e-8] /= wsum[wsum > 1e-8]
            return y[n_fft // 2:-(n_fft // 2)]

        def stft(y):
            pad = n_fft // 2
            yp = np.pad(y, pad, mode="reflect")
            n_frames = 1 + (len(yp) - n_fft) // hop
            idx = (np.arange(n_frames)[:, None] * hop + np.arange(n_fft))
            return np.fft.rfft(yp[idx] * win, axis=-1).T

        signal = istft(magnitude * angles)
        for _ in range(n_iters):
            angles = np.exp(1j * np.angle(stft(signal)))
            signal = istft(magnitude * angles)
        return signal

    def inv_mel_spec(self, mel, n_iters=30):
        """mel [n_mels, F] log-mel -> waveform via Griffin-Lim
        (`audio/tools.py:18-34`)."""
        return self.griffin_lim(self._linear_from_mel(mel), n_iters=n_iters)
