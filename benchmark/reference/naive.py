"""The plain MixGAN-TTS generator in naive mode: the linguistic encoder,
then `denoiser.timesteps` reverse steps (4 for LJSpeech) of the gated
residual denoiser from Gaussian noise.  No FFT decoder, mel_linear or
PostNet: naive mode has no coarse mel.

Its pieces are those of the shallow reference (`acoustic.py`, `blocks.py`):
the same `LinguisticEncoder`, `Denoiser` and `Diffusion`, under the same
keys, so one state dict loads strictly into this module and into the
program's naive model.  Inference at frame bucket T:

    x <- the start noise [B, T, M]
    for i = S-1 .. 0:  x0 = clamp(denoise_fn(x, i, features, spk), -1, 1)
                       x  = posterior_sample(x0, x, i, noise_k)
    mel = denorm(x) * mask

as MixGAN-TTS `model/diffusion.py` samples in naive mode.  Departures from
that source, each the program's own: the start noise and the step noises
are given (drawn by the program from a seeded generator; the judge draws
them again alike) and not drawn inside the loop; the start noise is not
masked, and the mask is applied once to the denormalised mel; the residual
stack runs in the kernels' arithmetic of `arith`, as in `acoustic.py`.
Training in naive mode has no reference here.
"""

import torch
import torch.nn as nn

from .acoustic import (
    LinguisticEncoder, Synthesized, make_diffusion, speaker_rows, speaker_table,
)
from .arith import FULL


class Generator(nn.Module):
    """MixGAN-TTS in naive mode."""

    mode = "naive"

    @staticmethod
    def reverse_steps(cfg):
        return cfg["denoiser"]["timesteps"]

    def __init__(self, cfg, stats):
        super().__init__()
        self.n_mels = cfg["n_mels"]
        self.linguistic_encoder = LinguisticEncoder(cfg, stats)
        self.speaker_emb = speaker_table(cfg)
        self.diffusion = make_diffusion(cfg, stats, self.reverse_steps(cfg))

    def synthesize(self, texts, src_lens, wb, src_w_lens, T, start_noise, step_noises,
                   decisions=None, arith=FULL, speakers=None):
        """The inference path of one batch at frame bucket T, with the
        noise the program drew (`start_noise` [B, T, M], `step_noises`
        [S, B, T, M]) and a multi-speaker model's `speakers` [B]."""
        enc = self.linguistic_encoder(texts, src_lens, wb, src_w_lens, T, decisions=decisions)
        maskf = enc.mel_mask[..., None].float()
        diff = self.diffusion
        x = diff.reverse(start_noise, enc.features, step_noises, arith,
                         speaker_rows(self.speaker_emb, speakers))
        mel = diff.denorm(x) * maskf
        return Synthesized(enc.features, None, mel, enc.mel_mask, enc.mel_len, enc.gap,
                           enc.decisions)
