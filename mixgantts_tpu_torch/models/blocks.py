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

Dropout sits where the flax blocks have it, at the same rates, as
`Dropout` modules (`nn.Dropout` on one device): active in training mode
(`module.train()`), the identity in eval mode.

Tensor parallelism (`parallel.tp`): the attention and FFN layers hold the
local shard of their sharded weights after `shard_state` and run the
Megatron collectives of `parallel.collectives` while a mesh is active; a
layer reads whether it is sharded from its weights' shapes.  With no mesh
(or one of one process) the collectives are the identity.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import (
    copy_to_model, data_rank, data_size, gather_from_model, model_rank, model_size,
    reduce_from_model, scatter_to_model,
)

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


def conv_last(conv, x, bias=True):
    """Apply a torch `nn.Conv1d` to channel-last x [B, T, C] (cast to the
    weight's type); `bias=False` leaves its bias out."""
    x = x.to(conv.weight.dtype)
    b = conv.bias if bias else None
    if conv.kernel_size[0] == 1 and conv.stride[0] == 1:
        return F.linear(x, conv.weight[:, :, 0], b)
    return F.conv1d(x.transpose(1, 2), conv.weight, b, conv.stride, conv.padding,
                    conv.dilation).transpose(1, 2)


def row_parallel(layer, x):
    """A `nn.Conv1d` or `nn.Linear` whose input channels are sharded over
    the mesh's `model` axis, on the matching shard of channel-last x: the
    partial products all-reduced, then the (replicated) bias added once."""
    if isinstance(layer, nn.Linear):
        y = F.linear(x.to(layer.weight.dtype), layer.weight)
    else:
        y = conv_last(layer, x, bias=False)
    y = reduce_from_model(y)
    return y if layer.bias is None else y + layer.bias


class Dropout(nn.Dropout):
    """`nn.Dropout` that keeps a sharded step's draws equal to one
    device's: while a mesh's data axis is active it draws the mask for the
    global batch (dim 0 times the data size) and keeps this rank's rows,
    and `heads_dim` names a dimension sharded over `model` whose mask is
    drawn whole and sliced.  Every rank holds torch's default generator in
    the same state, so the ranks draw what the one-device step draws."""

    def forward(self, x, heads_dim=None):
        n_data = data_size()
        n_model = model_size() if heads_dim is not None else 1
        if not self.training or self.p == 0 or (n_data == 1 and n_model == 1):
            return super().forward(x)
        shape = list(x.shape)
        shape[0] *= n_data
        if n_model > 1:
            shape[heads_dim] *= n_model
        # ones in x's memory layout, which sets the order the mask is drawn in
        order = sorted(range(x.dim()), key=lambda i: -x.stride(i))
        ones = torch.ones([shape[i] for i in order], dtype=x.dtype, device=x.device)
        ones = ones.permute([order.index(i) for i in range(x.dim())])
        mask = F.dropout(ones, self.p, True)
        mask = mask.narrow(0, data_rank() * x.shape[0], x.shape[0])
        if n_model > 1:
            mask = mask.narrow(heads_dim, model_rank() * x.shape[heads_dim], x.shape[heads_dim])
        return x * mask


def same_conv1d(c_in, c_out, kernel_size=1, dilation=1, bias=True, stride=1):
    """Conv1d with symmetric padding dilation * (k - 1) // 2."""
    return nn.Conv1d(c_in, c_out, kernel_size, stride=stride, dilation=dilation,
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

    def __init__(self, c_in, c_out, kernel_size=1, dilation=1, bias=True, stride=1):
        super().__init__()
        self.conv = same_conv1d(c_in, c_out, kernel_size, dilation, bias, stride)

    def forward(self, x):
        return conv_last(self.conv, x)


class LinearNorm(nn.Module):
    """The reference's LinearNorm: a `.linear` Linear, bias off by default."""

    def __init__(self, c_in, c_out, bias=False):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out, bias=bias)
        self.reset_like_jax()

    @torch.no_grad()
    def reset_like_jax(self, generator=None):
        """The JAX package's LinearNorm init: xavier-uniform, zero bias."""
        nn.init.xavier_uniform_(self.linear.weight, generator=generator)
        if self.linear.bias is not None:
            nn.init.zeros_(self.linear.bias)

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
    hidden, as the reference builds it).  Under tensor parallelism the conv
    is column-parallel and its output is gathered before the residual
    LayerNorm (and before the dropout, so the mask is drawn whole)."""

    def __init__(self, channels, kernel_size, dropout=0.0):
        super().__init__()
        self.conv = same_conv1d(channels, channels, kernel_size)
        self.drop = Dropout(dropout)

    def forward(self, x, mask):
        x = x * mask
        if self.conv.weight.shape[0] != self.conv.out_channels:   # a column shard
            y = F.relu(conv_last(self.conv, copy_to_model(x)))
            # gathered in the conv's [B, C, T] layout, which the dropout's
            # mask follows, as on one device
            y = (gather_from_model(y) if y.is_contiguous() else
                 gather_from_model(y.transpose(1, 2), dim=1).transpose(1, 2))
        else:
            y = F.relu(conv_last(self.conv, x))
        return self.drop(y) * mask


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
    shared by the heads.  Under tensor parallelism q, k and v are
    column-parallel and the output projection row-parallel: a rank attends
    with its whole heads, or, where a shard splits a head, gathers q, k and
    v first and takes its input channels of the output projection after."""

    def __init__(self, channels, n_heads, window_size, dropout=0.0):
        super().__init__()
        self.n_heads, self.window_size = n_heads, window_size
        self.drop = Dropout(dropout)
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

    @torch.no_grad()
    def reset_like_jax(self, generator=None):
        """The JAX package's named inits: xavier-uniform q, k and v
        projections, the relative tables N(0, 1 / k_channels)."""
        for conv in (self.conv_q, self.conv_k, self.conv_v):
            nn.init.xavier_uniform_(conv.weight, generator=generator)
        for emb in (self.emb_rel_k, self.emb_rel_v):
            nn.init.normal_(emb, std=emb.shape[-1] ** -0.5, generator=generator)

    def forward(self, x, attn_mask):
        # x [B, L, C]; attn_mask [B, 1, L, L] bool, True = valid
        B, L, C = x.shape
        d = C // self.n_heads
        local = self.conv_q.weight.shape[0]          # C, or a column shard of it
        tp = local != self.conv_q.out_channels
        whole_heads = local % d == 0
        if tp:
            x = copy_to_model(x)

        def heads(conv):   # fp32, as the JAX einsums' preferred_element_type
            y = conv_last(conv, x).float()
            if tp and not whole_heads:
                y = gather_from_model(y)
            return y.reshape(B, L, -1, d).transpose(1, 2)

        q, k, v = heads(self.conv_q), heads(self.conv_k), heads(self.conv_v)
        emb_k, emb_v = self.emb_rel_k, self.emb_rel_v
        if tp and whole_heads:   # the shared tables meet this rank's heads only
            emb_k, emb_v = copy_to_model(emb_k), copy_to_model(emb_v)
        scale = 1.0 / math.sqrt(d)
        scores = (q @ k.transpose(-1, -2)) * scale
        rel_k = _window_to_length(emb_k, L, self.window_size)
        scores = scores + _rel_to_abs(q @ rel_k[0].t()) * scale
        scores = torch.where(attn_mask, scores, NEG_INF)
        p_attn = self.drop(torch.softmax(scores, dim=-1), heads_dim=1 if tp and whole_heads
                           else None)
        out = p_attn @ v
        rel_v = _window_to_length(emb_v, L, self.window_size)
        out = out + _abs_to_rel(p_attn) @ rel_v[0]
        out = out.transpose(1, 2).reshape(B, L, -1)
        if not tp:
            return conv_last(self.conv_o, out)
        if not whole_heads:
            out = scatter_to_model(out)
        return row_parallel(self.conv_o, out)


class RelativeFFTBlock(nn.Module):
    """Layers of relative self-attention + LN + conv FFN + LN.
    `mask` is [B, L, 1] float, 1 = valid."""

    def __init__(self, hidden, n_heads, n_layers, kernel_size, window_size=4, dropout=0.0):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            RelativeSelfAttention(hidden, n_heads, window_size, dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(FFN(hidden, kernel_size, dropout)
                                        for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.drop = Dropout(dropout)

    def forward(self, x, mask):
        valid = mask[:, None, :, 0] > 0
        attn_mask = valid[:, :, None, :] & valid[:, :, :, None]   # [B, 1, L, L]
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = x * mask
            x = norm1(x + self.drop(attn(x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, mask)))
        return x * mask


class WordToPhonemeAttention(nn.Module):
    """Cross-attention, queries = frames, keys/values = phonemes; the query
    and word-mapping masks are applied after the softmax.  With `attn_prior`
    [B, P, T] (the CTC helper's) the scores are log-softmaxed and the log of
    the prior added.  Returns (out [B, T, C], (attn, attn_raw),
    attn_logprob), the last two [B, H, T, P]: `attn_raw` is taken after the
    query mask and before the mapping mask, `attn_logprob` before the
    softmax."""

    def __init__(self, n_heads, d_model):
        super().__init__()
        self.n_heads = n_heads
        self.w_qs = LinearNorm(d_model, d_model)
        self.w_ks = LinearNorm(d_model, d_model)
        self.w_vs = LinearNorm(d_model, d_model)
        self.fc = LinearNorm(d_model, d_model)

    def forward(self, q, k, v, key_mask, query_mask, map_mask, attn_prior=None):
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
        if attn_prior is not None:
            scores = (torch.log_softmax(scores, dim=-1)
                      + torch.log(attn_prior.transpose(1, 2)[:, None] + 1e-8))
        attn_raw = torch.softmax(scores, dim=-1) * query_mask[:, None, :, None]
        attn = attn_raw * map_mask[:, None, :, :]
        out = (attn @ vh).transpose(1, 2).reshape(B, T, C)
        return self.fc(out) + q, (attn, attn_raw), scores


class VariancePredictor(nn.Module):
    """Duration/pitch/energy predictor: (conv, ReLU, LayerNorm, dropout)
    x 2, then a linear projection; the mask is applied multiplicatively."""

    def __init__(self, c_in, filter_size, kernel_size, dropout=0.0):
        super().__init__()
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": ConvNorm(c_in, filter_size, kernel_size),
            "layer_norm_1": nn.LayerNorm(filter_size),
            "dropout_1": Dropout(dropout),
            "conv1d_2": ConvNorm(filter_size, filter_size, kernel_size),
            "layer_norm_2": nn.LayerNorm(filter_size),
            "dropout_2": Dropout(dropout),
        })
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x, mask):
        layers = self.conv_layer
        for i in (1, 2):
            x = layers[f"layer_norm_{i}"](F.relu(layers[f"conv1d_{i}"](x)))
            x = layers[f"dropout_{i}"](x)
        return self.linear_layer(x)[..., 0] * mask.to(x.dtype)
