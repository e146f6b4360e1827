"""Auxiliary FastSpeech2-style mel decoder and Tacotron2 PostNet
(`mixgantts_tpu/models/aux_decoder.py`), channel-last [B, T, C]."""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import NEG_INF, ConvNorm, conv_last, same_conv1d, sinusoid_position_table


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention (LayerNorm eps 1e-5)."""

    def __init__(self, n_heads, d_model):
        super().__init__()
        self.n_heads = n_heads
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.layer_norm = nn.LayerNorm(d_model)

    def forward(self, x, attn_mask):
        B, L, C = x.shape
        d = C // self.n_heads

        def split(t):
            return t.reshape(B, L, self.n_heads, d).transpose(1, 2)

        q, k, v = split(self.w_qs(x)), split(self.w_ks(x)), split(self.w_vs(x))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        scores = torch.where(attn_mask[:, None], scores, NEG_INF)
        out = torch.softmax(scores, dim=-1) @ v
        out = self.fc(out.transpose(1, 2).reshape(B, L, C))
        return self.layer_norm(out + x)


class PositionwiseFeedForward(nn.Module):
    """conv(k) -> ReLU -> conv(1), post-residual LayerNorm."""

    def __init__(self, d_model, d_inner, kernel_size):
        super().__init__()
        self.w_1 = same_conv1d(d_model, d_inner, kernel_size)
        self.w_2 = nn.Conv1d(d_inner, d_model, 1)
        self.layer_norm = nn.LayerNorm(d_model)

    def forward(self, x):
        y = conv_last(self.w_2, F.relu(conv_last(self.w_1, x)))
        return self.layer_norm(y + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model, n_heads, d_inner, kernel_size):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_heads, d_model)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size)

    def forward(self, x, mask, attn_mask):
        x = self.slf_attn(x, attn_mask) * mask[..., None]
        return self.pos_ffn(x) * mask[..., None]


class Decoder(nn.Module):
    """FFT decoder with absolute sinusoidal positions; `mask` True = valid."""

    def __init__(self, hidden=256, n_layers=6, n_heads=2, d_inner=1024,
                 kernel_size=9, max_seq_len=1000):
        super().__init__()
        self.layer_stack = nn.ModuleList(
            FFTBlock(hidden, n_heads, d_inner, kernel_size) for _ in range(n_layers))
        self.register_buffer(
            "position_enc",
            torch.from_numpy(sinusoid_position_table(max_seq_len + 1, hidden)),
            persistent=False)

    def forward(self, x, mask):
        """x [B, T, hidden] -> [B, T, hidden] in the parameters' type."""
        x = (x + self.position_enc[None, :x.shape[1]]).to(self.layer_stack[0].slf_attn.fc.weight.dtype)
        attn_mask = mask[:, None, :] & mask[:, :, None]
        for layer in self.layer_stack:
            x = layer(x, mask, attn_mask)
        return x


class PostNet(nn.Module):
    """Tacotron2 PostNet: five k = 5 convs with BatchNorm, tanh on all but
    the last.  BatchNorm always uses its running statistics (inference),
    kept in fp32 whatever the parameters' type, and normalises in fp32.
    Returns the residual correction; the caller adds it."""

    def __init__(self, n_mels=80, embedding_dim=512, kernel_size=5, n_convs=5):
        super().__init__()
        dims = [n_mels] + [embedding_dim] * (n_convs - 1) + [n_mels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(dims[i], dims[i + 1], kernel_size),
                          nn.BatchNorm1d(dims[i + 1]))
            for i in range(n_convs))

    def forward(self, x):
        x = x.transpose(1, 2)
        for i, (conv, bn) in enumerate(self.convolutions):
            y = conv.conv(x.to(bn.weight.dtype))
            x = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight.float(),
                             bn.bias.float(), training=False, eps=bn.eps).to(y.dtype)
            if i < len(self.convolutions) - 1:
                x = torch.tanh(x)
        return x.transpose(1, 2)
