"""Auxiliary FastSpeech2-style mel decoder and Tacotron2 PostNet
(`mixgantts_tpu/models/aux_decoder.py`), channel-last [B, T, C].

Dropout follows the module's training mode, as in `blocks.py`.  The
PostNet's BatchNorm follows flax's `BatchNorm`, which the JAX package
trains: in training mode it normalises with the (global) batch's
statistics and moves the running ones by momentum 0.99 with the biased batch variance
(E[x^2] - E[x]^2, flax's fast variance); in eval mode it uses the running
statistics."""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import (
    copy_to_model, data_size, data_sum, gather_from_model, scatter_to_model,
)
from .blocks import (
    NEG_INF, ConvNorm, Dropout, conv_last, row_parallel, same_conv1d,
    sinusoid_position_table,
)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention (LayerNorm eps 1e-5).  Under tensor
    parallelism `w_qs`, `w_ks` and `w_vs` are column-parallel and `fc`
    row-parallel, as in `blocks.RelativeSelfAttention`."""

    def __init__(self, n_heads, d_model, dropout=0.0):
        super().__init__()
        self.n_heads = n_heads
        self.drop = Dropout(dropout)
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.layer_norm = nn.LayerNorm(d_model)

    def forward(self, x, attn_mask):
        B, L, C = x.shape
        d = C // self.n_heads
        local = self.w_qs.weight.shape[0]            # C, or a column shard of it
        tp = local != self.w_qs.out_features
        whole_heads = local % d == 0
        xin = copy_to_model(x) if tp else x

        def split(linear):
            y = linear(xin)
            if tp and not whole_heads:
                y = gather_from_model(y)
            return y.reshape(B, L, -1, d).transpose(1, 2)

        q, k, v = split(self.w_qs), split(self.w_ks), split(self.w_vs)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        scores = torch.where(attn_mask[:, None], scores, NEG_INF)
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, L, -1)
        if not tp:
            out = self.fc(out)
        else:
            out = row_parallel(self.fc, out if whole_heads else scatter_to_model(out))
        return self.layer_norm(self.drop(out) + x)


class PositionwiseFeedForward(nn.Module):
    """conv(k) -> ReLU -> conv(1), post-residual LayerNorm.  Under tensor
    parallelism the Megatron MLP: `w_1` column-parallel, `w_2`
    row-parallel (one all-reduce)."""

    def __init__(self, d_model, d_inner, kernel_size, dropout=0.0):
        super().__init__()
        self.w_1 = same_conv1d(d_model, d_inner, kernel_size)
        self.w_2 = nn.Conv1d(d_inner, d_model, 1)
        self.layer_norm = nn.LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, x):
        if self.w_1.weight.shape[0] != self.w_1.out_channels:   # d_inner sharded
            y = row_parallel(self.w_2, F.relu(conv_last(self.w_1, copy_to_model(x))))
        else:
            y = conv_last(self.w_2, F.relu(conv_last(self.w_1, x)))
        return self.layer_norm(self.drop(y) + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model, n_heads, d_inner, kernel_size, dropout=0.0):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_heads, d_model, dropout)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size, dropout)

    def forward(self, x, mask, attn_mask):
        x = self.slf_attn(x, attn_mask) * mask[..., None]
        return self.pos_ffn(x) * mask[..., None]


class Decoder(nn.Module):
    """FFT decoder with absolute sinusoidal positions; `mask` True = valid."""

    def __init__(self, hidden=256, n_layers=6, n_heads=2, d_inner=1024,
                 kernel_size=9, max_seq_len=1000, dropout=0.0):
        super().__init__()
        self.layer_stack = nn.ModuleList(
            FFTBlock(hidden, n_heads, d_inner, kernel_size, dropout) for _ in range(n_layers))
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
    the last, dropout 0.5 after each (the rate is fixed, as in the JAX
    package).  The BatchNorm statistics stay fp32 whatever the parameters'
    type, and it normalises in fp32.  Returns the residual correction; the
    caller adds it."""

    MOMENTUM = 0.99   # flax's BatchNorm default, which the JAX package trains with

    def __init__(self, n_mels=80, embedding_dim=512, kernel_size=5, n_convs=5):
        super().__init__()
        dims = [n_mels] + [embedding_dim] * (n_convs - 1) + [n_mels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(dims[i], dims[i + 1], kernel_size),
                          nn.BatchNorm1d(dims[i + 1]))
            for i in range(n_convs))
        self.drop = Dropout(0.5)

    def forward(self, x, update_stats=True):
        """x [B, T, n_mels].  In training mode the batch statistics
        normalise, and move the running ones unless `update_stats` is
        False."""
        x = x.transpose(1, 2)
        for i, (conv, bn) in enumerate(self.convolutions):
            y = conv.conv(x.to(bn.weight.dtype))
            if self.training:
                x = self._batch_norm(y, bn, update_stats)
            else:
                x = F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                                 bn.weight.float(), bn.bias.float(), training=False,
                                 eps=bn.eps).to(y.dtype)
            if i < len(self.convolutions) - 1:
                x = torch.tanh(x)
            x = self.drop(x.transpose(1, 2)).transpose(1, 2)   # on the [B, T, C] view flax drops
        return x.transpose(1, 2)

    def _batch_norm(self, y, bn, update_stats):
        """flax's training-mode BatchNorm over the batch and time axes of
        y [B, C, T]; under data parallelism over the global batch (the sums
        of x and x^2 over the data ranks), so every rank normalises and
        moves its running statistics as one device does."""
        yf = y.float()
        if data_size() > 1:
            sums = data_sum(torch.stack([yf.sum(dim=(0, 2)), yf.square().sum(dim=(0, 2))]))
            mean, ex2 = sums / (yf.shape[0] * yf.shape[2] * data_size())
        else:
            mean, ex2 = yf.mean(dim=(0, 2)), yf.square().mean(dim=(0, 2))
        var = torch.clamp(ex2 - mean.square(), min=0.0)
        if update_stats:
            with torch.no_grad():
                m = self.MOMENTUM
                bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
                bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        out = ((yf - mean[:, None]) * torch.rsqrt(var + bn.eps)[:, None]
               * bn.weight.float()[:, None] + bn.bias.float()[:, None])
        return out.to(y.dtype)
