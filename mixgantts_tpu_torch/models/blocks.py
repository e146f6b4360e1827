"""Shared neural blocks (`mixgantts_tpu/models/blocks.py`), channel-last
[B, T, C] at every public function.

The module tree follows the original MixGAN-TTS torch repo's key layout
(bare `nn.Conv1d`s inside attention and FFN, `ConvNorm.conv`,
`LinearNorm.linear`), which is what `mixgantts_tpu/convert.py` reads and
`mixgantts_tpu_torch/convert.py` writes.

Activations follow the parameters' type: `conv_last` and `LinearNorm` cast
their input to their weight's type, so a model whose parameters were cast
to bf16 (`pipeline.TTSPipeline` under `compute_dtype: bfloat16`) computes
in bf16, and an fp32 one exactly as before.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# Large-negative logit used instead of -inf, so a fully masked row gives a
# uniform (then zeroed) distribution rather than NaNs.
NEG_INF = -1e9


def sinusoid_position_table(n_position, d_hid):
    """Sinusoid table [n_position, d_hid], float32 (built in float64)."""
    position = np.arange(n_position)[:, None].astype(np.float64)
    dim = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def conv_last(conv, x):
    """Apply a torch `nn.Conv1d` to channel-last x [B, T, C] (cast to the
    weight's type)."""
    x = x.to(conv.weight.dtype)
    if conv.kernel_size[0] == 1:
        return F.linear(x, conv.weight[:, :, 0], conv.bias)
    return conv(x.transpose(1, 2)).transpose(1, 2)


def same_conv1d(c_in, c_out, kernel_size=1, dilation=1, bias=True):
    """Conv1d with symmetric padding dilation * (k - 1) // 2."""
    return nn.Conv1d(c_in, c_out, kernel_size, dilation=dilation,
                     padding=dilation * (kernel_size - 1) // 2, bias=bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with eps = 1e-4 and `gamma`/`beta`."""

    def __init__(self, channels, eps=1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class ConvNorm(nn.Module):
    """The reference's ConvNorm: a `.conv` Conv1d, applied channel-last."""

    def __init__(self, c_in, c_out, kernel_size=1, dilation=1, bias=True):
        super().__init__()
        self.conv = same_conv1d(c_in, c_out, kernel_size, dilation, bias)

    def forward(self, x):
        return conv_last(self.conv, x)


class LinearNorm(nn.Module):
    """The reference's LinearNorm: a `.linear` Linear, bias off by default."""

    def __init__(self, c_in, c_out, bias=False):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out, bias=bias)
        nn.init.xavier_uniform_(self.linear.weight)

    def forward(self, x):
        return self.linear(x.to(self.linear.weight.dtype))


class Mish(nn.Module):
    def forward(self, x):
        return x * torch.tanh(F.softplus(x))


def diffusion_embedding(t, dim):
    """Sinusoidal diffusion-step embedding [B, dim] of integer steps t [B]."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                     * (-math.log(10000) / (half - 1)))
    args = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class FFN(nn.Module):
    """Masked conv + ReLU feed-forward of RelativeFFTBlock (hidden ->
    hidden, as the reference builds it)."""

    def __init__(self, channels, kernel_size):
        super().__init__()
        self.conv = same_conv1d(channels, channels, kernel_size)

    def forward(self, x, mask):
        return F.relu(conv_last(self.conv, x * mask)) * mask


def _rel_to_abs(x):
    """[B, H, L, 2L-1] relative-keyed logits -> [B, H, L, L] absolute."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, length * 2 * length)
    x = F.pad(x, (0, length - 1)).reshape(b, h, length + 1, 2 * length - 1)
    return x[:, :, :length, length - 1:]


def _abs_to_rel(x):
    """[B, H, L, L] absolute attention -> [B, H, L, 2L-1] relative-keyed."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, length - 1)).reshape(b, h, length * (2 * length - 1))
    x = F.pad(x, (length, 0)).reshape(b, h, length, 2 * length)
    return x[:, :, :, 1:]


def _window_to_length(emb, length, window_size):
    """Pad/slice a [1, 2w+1, d] relative table to [1, 2*length-1, d]."""
    pad_len = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start:start + 2 * length - 1]


class RelativeSelfAttention(nn.Module):
    """Multi-head self-attention with windowed relative position embeddings
    shared by the heads."""

    def __init__(self, channels, n_heads, window_size):
        super().__init__()
        self.n_heads, self.window_size = n_heads, window_size
        k_channels = channels // n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        std = k_channels ** -0.5
        self.emb_rel_k = nn.Parameter(
            torch.randn(1, 2 * window_size + 1, k_channels) * std)
        self.emb_rel_v = nn.Parameter(
            torch.randn(1, 2 * window_size + 1, k_channels) * std)

    def forward(self, x, attn_mask):
        # x [B, L, C]; attn_mask [B, 1, L, L] bool, True = valid
        B, L, C = x.shape
        d = C // self.n_heads

        def heads(conv):
            return conv_last(conv, x).reshape(B, L, self.n_heads, d).transpose(1, 2)

        q, k, v = heads(self.conv_q), heads(self.conv_k), heads(self.conv_v)
        scale = 1.0 / math.sqrt(d)
        scores = (q @ k.transpose(-1, -2)) * scale
        rel_k = _window_to_length(self.emb_rel_k, L, self.window_size)
        scores = scores + _rel_to_abs(q @ rel_k[0].t()) * scale
        scores = torch.where(attn_mask, scores, NEG_INF)
        p_attn = torch.softmax(scores, dim=-1)
        out = p_attn @ v
        rel_v = _window_to_length(self.emb_rel_v, L, self.window_size)
        out = out + _abs_to_rel(p_attn) @ rel_v[0]
        out = out.transpose(1, 2).reshape(B, L, C)
        return conv_last(self.conv_o, out)


class RelativeFFTBlock(nn.Module):
    """Layers of relative self-attention + LN + conv FFN + LN.
    `mask` is [B, L, 1] float, 1 = valid."""

    def __init__(self, hidden, n_heads, n_layers, kernel_size, window_size=4):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            RelativeSelfAttention(hidden, n_heads, window_size)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(FFN(hidden, kernel_size) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))

    def forward(self, x, mask):
        valid = mask[:, None, :, 0] > 0
        attn_mask = valid[:, :, None, :] & valid[:, :, :, None]   # [B, 1, L, L]
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = x * mask
            x = norm1(x + attn(x, attn_mask))
            x = norm2(x + ffn(x, mask))
        return x * mask


class WordToPhonemeAttention(nn.Module):
    """Cross-attention, queries = frames, keys/values = phonemes; the query
    and word-mapping masks are applied after the softmax."""

    def __init__(self, n_heads, d_model):
        super().__init__()
        self.n_heads = n_heads
        self.w_qs = LinearNorm(d_model, d_model)
        self.w_ks = LinearNorm(d_model, d_model)
        self.w_vs = LinearNorm(d_model, d_model)
        self.fc = LinearNorm(d_model, d_model)

    def forward(self, q, k, v, key_mask, query_mask, map_mask):
        # q [B, T, C]; k, v [B, P, C]; key_mask [B, P]; query_mask [B, T];
        # map_mask [B, T, P]; all masks bool, True = valid
        B, T, C = q.shape
        P = k.shape[1]
        d = C // self.n_heads

        def split(t, n):
            return t.reshape(B, n, self.n_heads, d).transpose(1, 2)

        qh, kh, vh = split(self.w_qs(q), T), split(self.w_ks(k), P), split(self.w_vs(v), P)
        scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(d)
        scores = torch.where(key_mask[:, None, None, :], scores, NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        attn = attn * query_mask[:, None, :, None] * map_mask[:, None, :, :]
        out = (attn @ vh).transpose(1, 2).reshape(B, T, C)
        return self.fc(out) + q


class VariancePredictor(nn.Module):
    """Duration/pitch/energy predictor: (conv, ReLU, LayerNorm) x 2, then a
    linear projection; the mask is applied multiplicatively."""

    def __init__(self, c_in, filter_size, kernel_size):
        super().__init__()
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": ConvNorm(c_in, filter_size, kernel_size),
            "layer_norm_1": nn.LayerNorm(filter_size),
            "conv1d_2": ConvNorm(filter_size, filter_size, kernel_size),
            "layer_norm_2": nn.LayerNorm(filter_size),
        })
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x, mask):
        layers = self.conv_layer
        x = layers["layer_norm_1"](F.relu(layers["conv1d_1"](x)))
        x = layers["layer_norm_2"](F.relu(layers["conv1d_2"](x)))
        return self.linear_layer(x)[..., 0] * mask.to(x.dtype)
