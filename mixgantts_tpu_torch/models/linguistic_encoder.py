"""Linguistic encoder (`mixgantts_tpu/models/linguistic_encoder.py`),
inference: phoneme encoder -> pitch/energy predictors and embeddings ->
word pooling -> word encoder -> word durations -> word-level length
regulation -> word-to-phoneme attention.

All shapes are static: the frame axis is always `max_mel_len`, with the
predicted `mel_len` and a mask.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..ops import (
    length_regulate, mapping_mask, rel_position_coef, sequence_mask,
    word_level_pooling,
)
from ..text.symbols import symbols
from .blocks import (
    RelativeFFTBlock, VariancePredictor, WordToPhonemeAttention,
    sinusoid_position_table,
)


class LinguisticEncoderOutput(NamedTuple):
    features: torch.Tensor        # [B, T_mel, H] frame-level conditioning
    pitch_pred: torch.Tensor      # [B, P]
    energy_pred: torch.Tensor     # [B, P]
    log_dur_w_pred: torch.Tensor  # [B, W]
    dur_w_rounded: torch.Tensor   # [B, W] frames per word
    mel_len: torch.Tensor         # [B]
    mel_mask: torch.Tensor        # [B, T_mel] bool, True = valid


def _bins(lo, hi, n_bins, quantization):
    if quantization == "log":
        edges = np.exp(np.linspace(np.log(lo), np.log(hi), n_bins - 1))
    else:
        edges = np.linspace(lo, hi, n_bins - 1)
    return torch.tensor(edges, dtype=torch.float32)


class LinguisticEncoder(nn.Module):
    def __init__(self, hidden=256, n_layers=4, n_heads=2, conv_kernel_size=9,
                 window_size=4, max_seq_len=1000, n_bins=256,
                 pitch_range=(-2.0, 10.0), energy_range=(-1.5, 8.0),
                 pitch_quantization="linear", energy_quantization="linear",
                 vp_filter_size=256, vp_kernel_size=3):
        super().__init__()
        H = hidden
        self.src_emb = nn.Embedding(len(symbols) + 1, H)
        self.phoneme_encoder = RelativeFFTBlock(
            H, n_heads, n_layers, conv_kernel_size, window_size)
        self.word_encoder = RelativeFFTBlock(
            H, n_heads, n_layers, conv_kernel_size, window_size)
        self.duration_predictor = VariancePredictor(H, vp_filter_size, vp_kernel_size)
        self.pitch_predictor = VariancePredictor(H, vp_filter_size, vp_kernel_size)
        self.energy_predictor = VariancePredictor(H, vp_filter_size, vp_kernel_size)
        self.pitch_embedding = nn.Embedding(n_bins, H)
        self.energy_embedding = nn.Embedding(n_bins, H)
        table = torch.from_numpy(sinusoid_position_table(max_seq_len + 1, H))[None]
        self.q_position_enc = nn.Parameter(table.clone(), requires_grad=False)
        self.kv_position_enc = nn.Parameter(table.clone(), requires_grad=False)
        self.w2p_attn = WordToPhonemeAttention(n_heads, H)
        self.register_buffer("pitch_bins", _bins(*pitch_range, n_bins, pitch_quantization),
                             persistent=False)
        self.register_buffer("energy_bins", _bins(*energy_range, n_bins, energy_quantization),
                             persistent=False)

    def forward(self, texts, src_p_len, word_boundary, src_w_len, max_mel_len,
                p_control=1.0, d_control=1.0):
        """texts [B, P] phoneme ids, src_p_len [B], word_boundary [B, W]
        phones per word, src_w_len [B]; max_mel_len is the static frame
        axis.  e_control does not exist: as in the reference, the energy
        prediction is scaled by p_control."""
        B, P = texts.shape
        W = word_boundary.shape[1]
        src_p_mask = sequence_mask(src_p_len, P)
        src_w_mask = sequence_mask(src_w_len, W)

        # phoneme encoding; the padding id embeds to zero
        emb = self.src_emb(texts) * (texts > 0)[..., None]
        enc_p = self.phoneme_encoder(emb, src_p_mask[..., None].to(emb.dtype))

        pitch_pred = self.pitch_predictor(enc_p, src_p_mask) * p_control
        enc_p = enc_p + self.pitch_embedding(
            torch.bucketize(pitch_pred, self.pitch_bins, right=True))
        energy_pred = self.energy_predictor(enc_p, src_p_mask) * p_control
        enc_p = enc_p + self.energy_embedding(
            torch.bucketize(energy_pred, self.energy_bins, right=True))

        # word encoding
        src_w_seq = word_level_pooling(enc_p, word_boundary, W, reduce="mean")
        enc_w = self.word_encoder(src_w_seq, src_w_mask[..., None].to(enc_p.dtype))

        # word durations: pool phoneme durations in the exp domain
        log_dur_p = self.duration_predictor(enc_p, src_p_mask)
        dur_w_sum = word_level_pooling(
            torch.exp(log_dur_p)[..., None], word_boundary, W, reduce="sum")[..., 0]
        log_dur_w_pred = torch.log(torch.clamp(dur_w_sum, min=1e-8)) * src_w_mask
        dur_w = torch.clamp(torch.round((torch.exp(log_dur_w_pred) - 1) * d_control),
                            min=0).long() * src_w_mask
        x, mel_len = length_regulate(enc_w, dur_w, max_mel_len)
        mel_len = torch.clamp(mel_len, max=max_mel_len)
        mel_mask = sequence_mask(mel_len, max_mel_len)

        # word-to-phoneme attention with intra-word relative positions
        map_mask = mapping_mask(dur_w, word_boundary, max_mel_len, P, W)
        q_coef = rel_position_coef(dur_w, max_mel_len, mel_mask)
        kv_coef = rel_position_coef(word_boundary, P, src_p_mask)
        q = x + q_coef[..., None] * self.q_position_enc[:, :max_mel_len]
        k = enc_p + kv_coef[..., None] * self.kv_position_enc[:, :P]
        features = self.w2p_attn(q, k, k, src_p_mask, mel_mask, map_mask)

        return LinguisticEncoderOutput(
            features=features, pitch_pred=pitch_pred, energy_pred=energy_pred,
            log_dur_w_pred=log_dur_w_pred, dur_w_rounded=dur_w,
            mel_len=mel_len, mel_mask=mel_mask)
