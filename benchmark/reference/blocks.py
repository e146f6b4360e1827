"""Plain blocks of the MixGAN-TTS generator, channel-last [B, T, C], in
float32 on one device.

Written from the published architecture (MaxMax2016/MixGAN-TTS: a
FastSpeech2-style encoder with relative self-attention, word pooling and
word-to-phoneme attention; a FastSpeech2 decoder and Tacotron2 PostNet).
The module tree uses the published torch key layout, so one state dict
loads into this reference and into the program under test.  Dropout sits
where the published blocks have it and draws in the same order, on tensors
of the same shapes and layouts, so that a training step seeded alike draws
the same masks as the program.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e9


def sequence_mask(lengths, max_len):
    """[B] lengths -> [B, max_len] bool, True = valid."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None].long()


def sinusoid_position_table(n_position, d_hid):
    position = np.arange(n_position)[:, None].astype(np.float64)
    dim = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def conv_last(conv, x):
    """A torch Conv1d on channel-last x [B, T, C]."""
    if conv.kernel_size[0] == 1 and conv.stride[0] == 1:
        return F.linear(x, conv.weight[:, :, 0], conv.bias)
    return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias, conv.stride, conv.padding,
                    conv.dilation).transpose(1, 2)


def same_conv1d(c_in, c_out, kernel_size=1, stride=1):
    return nn.Conv1d(c_in, c_out, kernel_size, stride=stride, padding=(kernel_size - 1) // 2)


class ConvNorm(nn.Module):
    def __init__(self, c_in, c_out, kernel_size=1, stride=1):
        super().__init__()
        self.conv = same_conv1d(c_in, c_out, kernel_size, stride)

    def forward(self, x):
        return conv_last(self.conv, x)


class LinearNorm(nn.Module):
    def __init__(self, c_in, c_out, bias=False):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out, bias=bias)

    def forward(self, x):
        return self.linear(x)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-4, `gamma`/`beta`."""

    def __init__(self, channels, eps=1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class Mish(nn.Module):
    def forward(self, x):
        return x * torch.tanh(F.softplus(x))


def diffusion_embedding(t, dim):
    half = dim // 2
    freq = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                     * (-math.log(10000) / (half - 1)))
    args = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# --- word and frame bookkeeping ----------------------------------------------

def segment_ids(counts, out_len):
    """[B, W] counts -> [B, out_len] segment index of each position."""
    ends = torch.cumsum(counts.long(), dim=-1)
    pos = torch.arange(out_len, device=counts.device)[None, :, None]
    return (pos >= ends[:, None, :]).sum(dim=-1)


def word_pooling(x, counts, n_words, reduce):
    seg = segment_ids(counts, x.shape[1])
    words = torch.arange(n_words, device=x.device)[None, :, None]
    one_hot = (seg[:, None, :] == words).to(x.dtype)
    pooled = torch.bmm(one_hot, x)
    if reduce == "sum":
        return pooled
    return pooled / torch.clamp(counts.to(x.dtype), min=1.0)[:, :, None]


def length_regulate(x, durations, max_len):
    seg = segment_ids(durations, max_len)
    mel_len = durations.long().sum(dim=-1)
    W, H = x.shape[1], x.shape[2]
    frames = torch.gather(x, 1, torch.clamp(seg, 0, W - 1)[:, :, None].expand(-1, -1, H))
    valid = torch.arange(max_len, device=x.device)[None, :] < mel_len[:, None]
    return frames * valid[:, :, None].to(x.dtype), mel_len


def mapping_mask(dur_w, wb, n_frames, n_phones, n_words):
    frame_word = segment_ids(dur_w, n_frames)
    phone_word = segment_ids(wb, n_phones)
    same = frame_word[:, :, None] == phone_word[:, None, :]
    return same & (frame_word[:, :, None] < n_words) & (phone_word[:, None, :] < n_words)


def rel_position_coef(counts, out_len, valid_mask):
    counts = counts.long()
    ids = torch.clamp(segment_ids(counts, out_len), 0, counts.shape[1] - 1)
    starts = torch.cumsum(counts, dim=-1) - counts
    seg_start = torch.gather(starts, 1, ids)
    seg_len = torch.gather(counts, 1, ids)
    pos = torch.arange(out_len, device=counts.device)[None, :]
    coef = (pos - seg_start).float() / torch.clamp(seg_len.float(), min=1.0)
    return coef * valid_mask.float()


# --- encoder blocks ------------------------------------------------------------

def _rel_to_abs(x):
    b, h, length, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, length * 2 * length)
    x = F.pad(x, (0, length - 1)).reshape(b, h, length + 1, 2 * length - 1)
    return x[:, :, :length, length - 1:]


def _abs_to_rel(x):
    b, h, length, _ = x.shape
    x = F.pad(x, (0, length - 1)).reshape(b, h, length * (2 * length - 1))
    x = F.pad(x, (length, 0)).reshape(b, h, length, 2 * length)
    return x[:, :, :, 1:]


def _window_to_length(emb, length, window_size):
    pad_len = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start:start + 2 * length - 1]


class RelativeSelfAttention(nn.Module):
    """Self-attention with windowed relative position tables shared by
    the heads."""

    def __init__(self, channels, n_heads, window_size, dropout):
        super().__init__()
        self.n_heads, self.window_size = n_heads, window_size
        self.drop = nn.Dropout(dropout)
        k_channels = channels // n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window_size + 1, k_channels))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window_size + 1, k_channels))

    def forward(self, x, attn_mask):
        B, L, C = x.shape
        d = C // self.n_heads

        def heads(conv):
            return conv_last(conv, x).reshape(B, L, -1, d).transpose(1, 2)

        q, k, v = heads(self.conv_q), heads(self.conv_k), heads(self.conv_v)
        scale = 1.0 / math.sqrt(d)
        scores = (q @ k.transpose(-1, -2)) * scale
        rel_k = _window_to_length(self.emb_rel_k, L, self.window_size)
        scores = scores + _rel_to_abs(q @ rel_k[0].t()) * scale
        scores = torch.where(attn_mask, scores, NEG_INF)
        p_attn = self.drop(torch.softmax(scores, dim=-1))
        out = p_attn @ v
        rel_v = _window_to_length(self.emb_rel_v, L, self.window_size)
        out = out + _abs_to_rel(p_attn) @ rel_v[0]
        return conv_last(self.conv_o, out.transpose(1, 2).reshape(B, L, -1))


class FFN(nn.Module):
    def __init__(self, channels, kernel_size, dropout):
        super().__init__()
        self.conv = same_conv1d(channels, channels, kernel_size)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, mask):
        x = x * mask
        return self.drop(F.relu(conv_last(self.conv, x))) * mask


class RelativeFFTBlock(nn.Module):
    def __init__(self, hidden, n_heads, n_layers, kernel_size, window_size, dropout):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            RelativeSelfAttention(hidden, n_heads, window_size, dropout) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(FFN(hidden, kernel_size, dropout)
                                        for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.drop = nn.Dropout(dropout)

    def forward(self, x, mask):
        valid = mask[:, None, :, 0] > 0
        attn_mask = valid[:, :, None, :] & valid[:, :, :, None]
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = x * mask
            x = norm1(x + self.drop(attn(x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, mask)))
        return x * mask


class WordToPhonemeAttention(nn.Module):
    """Frames attend to phonemes; the query and word-mapping masks are
    applied after the softmax; with a prior [B, P, T], log-softmax plus
    the log of the prior."""

    def __init__(self, n_heads, d_model):
        super().__init__()
        self.n_heads = n_heads
        self.w_qs = LinearNorm(d_model, d_model)
        self.w_ks = LinearNorm(d_model, d_model)
        self.w_vs = LinearNorm(d_model, d_model)
        self.fc = LinearNorm(d_model, d_model)

    def forward(self, q, k, v, key_mask, query_mask, map_mask, attn_prior=None):
        B, T, C = q.shape
        P = k.shape[1]
        d = C // self.n_heads

        def split(t, n):
            return t.reshape(B, n, self.n_heads, d).transpose(1, 2)

        qh, kh, vh = split(self.w_qs(q), T), split(self.w_ks(k), P), split(self.w_vs(v), P)
        scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(d)
        scores = torch.where(key_mask[:, None, None, :], scores, NEG_INF)
        if attn_prior is not None:
            scores = (torch.log_softmax(scores, dim=-1)
                      + torch.log(attn_prior.transpose(1, 2)[:, None] + 1e-8))
        attn_raw = torch.softmax(scores, dim=-1) * query_mask[:, None, :, None]
        attn = attn_raw * map_mask[:, None, :, :]
        out = (attn @ vh).transpose(1, 2).reshape(B, T, C)
        return self.fc(out) + q


class VariancePredictor(nn.Module):
    def __init__(self, c_in, filter_size, kernel_size, dropout):
        super().__init__()
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": ConvNorm(c_in, filter_size, kernel_size),
            "layer_norm_1": nn.LayerNorm(filter_size),
            "dropout_1": nn.Dropout(dropout),
            "conv1d_2": ConvNorm(filter_size, filter_size, kernel_size),
            "layer_norm_2": nn.LayerNorm(filter_size),
            "dropout_2": nn.Dropout(dropout),
        })
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x, mask):
        layers = self.conv_layer
        for i in (1, 2):
            x = layers[f"layer_norm_{i}"](F.relu(layers[f"conv1d_{i}"](x)))
            x = layers[f"dropout_{i}"](x)
        return self.linear_layer(x)[..., 0] * mask.to(x.dtype)


# --- decoder and PostNet ---------------------------------------------------------

class MultiHeadAttention(nn.Module):
    """Post-LN self-attention (LayerNorm eps 1e-5)."""

    def __init__(self, n_heads, d_model, dropout):
        super().__init__()
        self.n_heads = n_heads
        self.drop = nn.Dropout(dropout)
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.layer_norm = nn.LayerNorm(d_model)

    def forward(self, x, attn_mask):
        B, L, C = x.shape
        d = C // self.n_heads

        def split(linear):
            return linear(x).reshape(B, L, -1, d).transpose(1, 2)

        q, k, v = split(self.w_qs), split(self.w_ks), split(self.w_vs)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        scores = torch.where(attn_mask[:, None], scores, NEG_INF)
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, L, -1)
        return self.layer_norm(self.drop(self.fc(out)) + x)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model, d_inner, kernel_size, dropout):
        super().__init__()
        self.w_1 = same_conv1d(d_model, d_inner, kernel_size)
        self.w_2 = nn.Conv1d(d_inner, d_model, 1)
        self.layer_norm = nn.LayerNorm(d_model)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        y = conv_last(self.w_2, F.relu(conv_last(self.w_1, x)))
        return self.layer_norm(self.drop(y) + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model, n_heads, d_inner, kernel_size, dropout):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_heads, d_model, dropout)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size, dropout)

    def forward(self, x, mask, attn_mask):
        x = self.slf_attn(x, attn_mask) * mask[..., None]
        return self.pos_ffn(x) * mask[..., None]


class Decoder(nn.Module):
    def __init__(self, hidden, n_layers, n_heads, d_inner, kernel_size, max_seq_len, dropout):
        super().__init__()
        self.layer_stack = nn.ModuleList(
            FFTBlock(hidden, n_heads, d_inner, kernel_size, dropout) for _ in range(n_layers))
        self.register_buffer("position_enc", torch.from_numpy(
            sinusoid_position_table(max_seq_len + 1, hidden)), persistent=False)

    def forward(self, x, mask):
        x = x + self.position_enc[None, :x.shape[1]]
        attn_mask = mask[:, None, :] & mask[:, :, None]
        for layer in self.layer_stack:
            x = layer(x, mask, attn_mask)
        return x


class PostNet(nn.Module):
    """Five k = 5 convs with BatchNorm, tanh on all but the last, dropout
    0.5 after each.  Training normalises with the batch's biased
    statistics and moves the running ones by momentum 0.99 (flax's
    BatchNorm, which the JAX original trains); eval uses the running
    ones."""

    MOMENTUM = 0.99

    def __init__(self, n_mels=80, embedding_dim=512, kernel_size=5, n_convs=5):
        super().__init__()
        dims = [n_mels] + [embedding_dim] * (n_convs - 1) + [n_mels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(dims[i], dims[i + 1], kernel_size),
                          nn.BatchNorm1d(dims[i + 1]))
            for i in range(n_convs))
        self.drop = nn.Dropout(0.5)

    def forward(self, x, update_stats=True):
        x = x.transpose(1, 2)
        for i, (conv, bn) in enumerate(self.convolutions):
            y = conv.conv(x)
            if self.training:
                mean, ex2 = y.mean(dim=(0, 2)), y.square().mean(dim=(0, 2))
                var = torch.clamp(ex2 - mean.square(), min=0.0)
                if update_stats:
                    with torch.no_grad():
                        m = self.MOMENTUM
                        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
                        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
                x = ((y - mean[:, None]) * torch.rsqrt(var + bn.eps)[:, None]
                     * bn.weight[:, None] + bn.bias[:, None])
            else:
                x = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                 training=False, eps=bn.eps)
            if i < len(self.convolutions) - 1:
                x = torch.tanh(x)
            x = self.drop(x.transpose(1, 2)).transpose(1, 2)
        return x.transpose(1, 2)
