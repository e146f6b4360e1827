"""DeepSpeaker ResCNN speaker embedder (`mixgantts_tpu/models/speaker_embedder.py`)
and its feature pipeline.

Parity targets: `deepspeaker/conv_models.py:22-140` (4-stage ResCNN 64->512
with clipped ReLU, temporal average, 512-d affine, L2 norm),
`deepspeaker/audio_ds.py:34-44,127-137` (energy-threshold trim + 64-filter
log-fbank with per-frame mean/std normalization),
`deepspeaker/batcher.py:23-29` (sample/pad to 160 frames) and the
`PreDefinedEmbedder` wrapper (`model/speaker_embedder.py:11-42`).

The fbank features are host numpy, a copy of the JAX package's
(python_speech_features' defaults: 25 ms/10 ms frames, preemphasis 0.97,
HTK mel filterbank, power spectrum 1/NFFT * |FFT|^2).  The network is an
`nn.Module` computing in NCHW on the embedder's device; it takes the JAX
module's [B, T, 64, 1] frames.  flax's `padding="SAME"` with stride 2 pads
the extra row and column on the high side, so the convolutions pad
explicitly; the flatten before `affine` is taken channel-fastest
([B, T/16, 4, 512] -> [B, T/16, 2048]), as in flax's NHWC; BatchNorm uses
flax's eps 1e-5 and fp32 statistics.  Pretrained Keras `.h5` weights load
through `convert_keras_weights` (h5py) and `convert.deepspeaker_state_dict`.
"""

import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.tools import resolve_device
from .initializers import init_like_jax

SAMPLE_RATE = 22050
NUM_FRAMES = 160
NUM_FBANKS = 64


# --- feature pipeline (python_speech_features.fbank equivalent) --------------

def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asanyarray(f) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asanyarray(m) / 2595.0) - 1.0)


def _htk_filterbank(nfilt, nfft, sr):
    low, high = 0.0, sr / 2.0
    mel_pts = np.linspace(_hz_to_mel_htk(low), _hz_to_mel_htk(high),
                          nfilt + 2)
    bins = np.floor((nfft + 1) * _mel_to_hz_htk(mel_pts) / sr).astype(int)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for m in range(1, nfilt + 1):
        f_m_minus, f_m, f_m_plus = bins[m - 1], bins[m], bins[m + 1]
        for k in range(f_m_minus, f_m):
            fb[m - 1, k] = (k - f_m_minus) / max(f_m - f_m_minus, 1)
        for k in range(f_m, f_m_plus):
            fb[m - 1, k] = (f_m_plus - k) / max(f_m_plus - f_m, 1)
    return fb


def calculate_nfft(sample_rate, winlen):
    window_length_samples = winlen * sample_rate
    nfft = 1
    while nfft < window_length_samples:
        nfft *= 2
    return nfft


def psf_fbank(signal, sr, nfft, nfilt=NUM_FBANKS, winlen=0.025, winstep=0.01,
              preemph=0.97):
    """python_speech_features.fbank equivalent (rectangular window)."""
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])
    frame_len = int(round(winlen * sr))
    frame_step = int(round(winstep * sr))
    if len(signal) <= frame_len:
        n_frames = 1
    else:
        n_frames = 1 + int(math.ceil((len(signal) - frame_len) / frame_step))
    pad_len = (n_frames - 1) * frame_step + frame_len
    signal = np.pad(signal, (0, max(0, pad_len - len(signal))))
    idx = (np.arange(n_frames)[:, None] * frame_step
           + np.arange(frame_len)[None, :])
    frames = signal[idx]
    pspec = (1.0 / nfft) * np.abs(np.fft.rfft(frames, nfft, axis=1)) ** 2
    fb = _htk_filterbank(nfilt, nfft, sr)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(float).eps, feat)
    return feat


def normalize_frames(m, epsilon=1e-12):
    mean = m.mean(axis=1, keepdims=True)
    std = np.maximum(m.std(axis=1, keepdims=True), epsilon)
    return (m - mean) / std


def read_mfcc(audio, sample_rate, win_length):
    """Energy-trimmed, frame-normalized fbank features
    (`deepspeaker/audio_ds.py:34-44`)."""
    energy = np.abs(audio)
    silence_threshold = np.percentile(energy, 95)
    offsets = np.where(energy > silence_threshold)[0]
    audio = audio[offsets[0]:offsets[-1]] if len(offsets) > 1 else audio
    nfft = calculate_nfft(sample_rate, win_length / sample_rate)
    return normalize_frames(
        psf_fbank(audio, sample_rate, nfft)).astype(np.float32)


def sample_from_mfcc(mfcc, max_length=NUM_FRAMES, rng=None):
    if mfcc.shape[0] >= max_length:
        r = (rng or np.random).randint(0, len(mfcc) - max_length + 1) \
            if mfcc.shape[0] > max_length else 0
        s = mfcc[r:r + max_length]
    else:
        s = np.vstack([mfcc, np.zeros((max_length - len(mfcc),
                                       mfcc.shape[1]))])
    return s[..., None].astype(np.float32)


# --- ResCNN ------------------------------------------------------------------

STAGE_FILTERS = (64, 128, 256, 512)


def clipped_relu(x):
    return torch.clamp(x, 0.0, 20.0)


def _same_pad(x, kernel, stride):
    """flax/TF "SAME" padding of NCHW x for a square kernel: the output is
    ceil(n / stride) long, and the odd row or column goes to the high side."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv(nn.Conv2d):
    """A square convolution with flax's "SAME" padding."""

    def forward(self, x):
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride[0]))


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.01)   # flax's eps and momentum 0.99


class IdentityBlock(nn.Module):
    def __init__(self, filters):
        super().__init__()
        self.conv_2a, self.bn_2a = SameConv(filters, filters, 3), _bn(filters)
        self.conv_2b, self.bn_2b = SameConv(filters, filters, 3), _bn(filters)

    def forward(self, x):
        y = clipped_relu(self.bn_2a(self.conv_2a(x)))
        y = clipped_relu(self.bn_2b(self.conv_2b(y)))
        return clipped_relu(y + x)


class Stage(nn.Module):
    """A 5x5 stride-2 convolution, BatchNorm and clipped ReLU, then three
    identity blocks."""

    def __init__(self, c_in, filters):
        super().__init__()
        self.conv, self.bn = SameConv(c_in, filters, 5, stride=2), _bn(filters)
        self.blocks = nn.ModuleList(IdentityBlock(filters) for _ in range(3))

    def forward(self, x):
        x = clipped_relu(self.bn(self.conv(x)))
        for block in self.blocks:
            x = block(x)
        return x


class DeepSpeakerResCNN(nn.Module):
    """[B, T, 64, 1] fbank frames -> [B, 512] L2-normalized embedding."""

    def __init__(self):
        super().__init__()
        ins = (1,) + STAGE_FILTERS[:-1]
        self.stages = nn.ModuleList(Stage(c, f) for c, f in zip(ins, STAGE_FILTERS))
        self.affine = nn.Linear(NUM_FBANKS // 16 * STAGE_FILTERS[-1], 512)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for stage in self.stages:
            x = stage(x)
        B, _, T = x.shape[:3]
        x = x.permute(0, 2, 3, 1).reshape(B, T, -1)     # channel fastest, as flax
        x = self.affine(x.mean(dim=1))                  # temporal average
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def convert_keras_weights(h5_path):
    """Keras ResCNN_triplet .h5 -> the JAX package's params/batch_stats
    trees (`convert.deepspeaker_state_dict` takes them to the module);
    h5py is imported here, so the port imports without it."""
    import h5py

    params, stats = {}, {}

    def conv(name):
        g = f[name][name]
        return {"kernel": np.asarray(g["kernel:0"]),
                "bias": np.asarray(g["bias:0"])}

    def bn(name):
        g = f[name][name]
        return ({"scale": np.asarray(g["gamma:0"]),
                 "bias": np.asarray(g["beta:0"])},
                {"mean": np.asarray(g["moving_mean:0"]),
                 "var": np.asarray(g["moving_variance:0"])})

    with h5py.File(h5_path, "r") as f0:
        f = f0["model_weights"] if "model_weights" in f0 else f0
        for stage, filters in enumerate([64, 128, 256, 512], start=1):
            cname = f"conv{filters}-s"
            params[cname] = conv(cname)
            p, s = bn(cname + "_bn")
            params[cname + "_bn"], stats[cname + "_bn"] = p, s
            for block in range(3):
                base = f"res{stage}_{block}_branch"
                bp, bs = {}, {}
                bp["conv_2a"] = conv(base + "_2a")
                bp["conv_2b"] = conv(base + "_2b")
                p, s = bn(base + "_2a_bn")
                bp["bn_2a"], bs["bn_2a"] = p, s
                p, s = bn(base + "_2b_bn")
                bp["bn_2b"], bs["bn_2b"] = p, s
                params[f"res{stage}_{block}"] = bp
                stats[f"res{stage}_{block}"] = bs
        params["affine"] = conv("affine") if "affine" in f else {
            "kernel": np.asarray(f["affine"]["affine"]["kernel:0"]),
            "bias": np.asarray(f["affine"]["affine"]["bias:0"])}
    return params, stats


class PreDefinedEmbedder:
    """Preprocess-time wrapper (`model/speaker_embedder.py:11-42`): wav ->
    (1, 512) embedding, the network on `device` (cuda unless the caller
    names another).  Weights: the Keras checkpoint `ckpt_path` (by default
    `vocoder_ckpt/ResCNN_triplet_training_checkpoint_265.h5` beside the
    package), which needs h5py; without that file, a random init from a
    generator seeded 0, which it says (the JAX package's random init
    cannot be reproduced: `ROADMAP.md`)."""

    def __init__(self, config, ckpt_path=None, device=None):
        pp = config["preprocessing"]
        self.sampling_rate = pp["audio"]["sampling_rate"]
        self.win_length = pp["stft"]["win_length"]
        self.embedder_type = pp.get("speaker_embedder", "DeepSpeaker")
        if self.embedder_type != "DeepSpeaker":
            raise NotImplementedError(self.embedder_type)
        self.device = resolve_device(device)
        self.module = DeepSpeakerResCNN()
        if ckpt_path is None:
            ckpt_path = os.path.join(
                os.path.dirname(os.path.dirname(__file__)), "..",
                "vocoder_ckpt", "ResCNN_triplet_training_checkpoint_265.h5")
        if os.path.isfile(ckpt_path):
            from ..convert import deepspeaker_state_dict

            self.module.load_state_dict(
                deepspeaker_state_dict(*convert_keras_weights(ckpt_path)), strict=True)
        else:
            print(f"DeepSpeaker: no checkpoint at {ckpt_path}; random weights (seed 0)")
            init_like_jax(self.module, torch.Generator().manual_seed(0))
        self.module.to(self.device).eval()

    @torch.no_grad()
    def embed(self, feats):
        """[B, T, 64, 1] fbank frames (numpy) -> [B, 512] numpy."""
        x = torch.as_tensor(np.asarray(feats, dtype=np.float32), device=self.device)
        return self.module(x).cpu().numpy()

    def __call__(self, audio):
        mfcc = read_mfcc(np.asarray(audio), self.sampling_rate, self.win_length)
        return self.embed(sample_from_mfcc(mfcc)[None])
