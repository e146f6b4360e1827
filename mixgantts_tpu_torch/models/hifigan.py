"""HiFi-GAN V1 generator (`mixgantts_tpu/models/hifigan.py`).

conv_pre (k7) -> per stage [leaky_relu -> ConvTranspose1d -> MRF stage] ->
leaky_relu -> conv_post (k7) -> tanh.  The module tree follows the torch
HiFi-GAN key layout (`conv_pre`, `ups.{i}`, `resblocks.{i*n_k+j}.convs1.{c}`,
`convs2.{c}`, `conv_post`) with plain `.weight`s: weight norm is folded
when a checkpoint is loaded.

The MRF stages run in `ops.mrf`: the hand-written CUDA kernel for CUDA
tensors, the plain version for CPU tensors.  The upsample is
`F.conv_transpose1d(stride=u, padding=(k-u)//2)`, which is exactly the JAX
package's sub-pixel upsample.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mrf import (
    LRELU_SLOPE, mrf_stack, mrf_stack_folded, stack_mrf_params,
    stack_mrf_params_folded,
)
from ..utils.tools import resolve_device


class ResBlock1(nn.Module):
    """Parameters of one MRF branch (kernel k, dilations d); the math runs
    in `ops.mrf`."""

    def __init__(self, channels, kernel_size, dilations=(1, 3, 5)):
        super().__init__()
        k = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d, padding=d * (k - 1) // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, padding=(k - 1) // 2)
            for _ in dilations)


class HiFiGANGenerator(nn.Module):
    def __init__(self, n_mels=80, upsample_rates=(8, 8, 2, 2),
                 upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel=512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        c0 = upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2))
            for rk, rd in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self._stacked = None
        self.to(device)

    @classmethod
    def from_config(cls, config, device=None):
        return cls(
            n_mels=config.get("num_mels", 80),
            upsample_rates=config["upsample_rates"],
            upsample_kernel_sizes=config["upsample_kernel_sizes"],
            upsample_initial_channel=config["upsample_initial_channel"],
            resblock_kernel_sizes=config["resblock_kernel_sizes"],
            resblock_dilation_sizes=config["resblock_dilation_sizes"],
            device=device)

    def _apply(self, fn, *args, **kwargs):
        self._stacked = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._stacked = None
        super()._load_from_state_dict(*args, **kwargs)

    def forward(self, mel):
        """mel [B, T, n_mels] log-mel -> waveform [B, T * prod(rates)]."""
        return fused_apply(self, mel)


def _stage_mode(channels, frames):
    """How a stage's MRF runs, as in the JAX `fused_apply`: time-folded for
    C <= 64 (F = 128 / C) when F divides the frames, whole-stage for
    C <= 128, one call per branch above."""
    fold = 128 // channels if channels < 128 and 128 % channels == 0 else 0
    if fold and channels <= 64 and frames % fold == 0:
        return "folded"
    return "whole" if channels <= 128 else "branchwise"


def _stage_weights(generator, stage, mode, channels):
    rks = generator.resblock_kernel_sizes
    dils = generator.resblock_dilation_sizes[0]
    if mode == "folded":
        return stack_mrf_params_folded(generator, stage, 128 // channels, rks, dils)
    if mode == "whole":
        return stack_mrf_params(generator, stage, rks, dils)
    return [stack_mrf_params(generator, stage, (rk,), dils, branches=[(j, rk)])
            for j, rk in enumerate(rks)]


def fused_apply(generator, mel):
    """HiFi-GAN forward with each stage's MRF in one `ops.mrf` call (three
    one-branch calls at C > 128).  mel [B, T, n_mels] -> [B, T * hop]."""
    rks = generator.resblock_kernel_sizes
    dils = generator.resblock_dilation_sizes
    # the kernels share one dilation schedule across branches (true for
    # HiFi-GAN V1); per-branch dilations would run the wrong taps
    if any(d != dils[0] for d in dils):
        raise NotImplementedError(
            f"fused_apply requires identical resblock_dilation_sizes per "
            f"branch, got {dils}")
    dils = dils[0]
    if generator._stacked is None:
        generator._stacked = {}
    x = generator.conv_pre(mel.transpose(1, 2))                  # [B, C, T]
    for i, up in enumerate(generator.ups):
        x = up(F.leaky_relu(x, LRELU_SLOPE))
        B, C, T = x.shape
        mode = _stage_mode(C, T)
        if (i, mode) not in generator._stacked:
            generator._stacked[i, mode] = _stage_weights(generator, i, mode, C)
        stacked = generator._stacked[i, mode]
        x = x.transpose(1, 2).contiguous()                       # [B, T, C]
        if mode == "folded":
            fold = stacked["fold"]
            x = mrf_stack_folded(x.reshape(B, T // fold, fold * C), stacked,
                                 rks, dils, prefolded=True)
        elif mode == "whole":
            x = mrf_stack(x, stacked, rks, dils)
        else:
            x = sum(mrf_stack(x, st, (rk,), dils)
                    for st, rk in zip(stacked, rks)) / len(rks)
        x = x.transpose(1, 2)
    x = generator.conv_post(F.leaky_relu(x, LRELU_SLOPE))
    return torch.tanh(x)[:, 0]


def fold_weight_norm(weight_v, weight_g):
    """Fold torch weight norm (v, g) into a plain kernel g * v / ||v||,
    the functional equivalent of `remove_weight_norm`."""
    v = np.asarray(weight_v)
    g = np.asarray(weight_g)
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def plain_state_dict(state_dict):
    """A torch HiFi-GAN generator state_dict with weight norm
    (`.weight_g`/`.weight_v`) -> plain `.weight`s, as numpy arrays."""
    out = {}
    for key, value in state_dict.items():
        value = np.asarray(value)
        if key.endswith(".weight_v"):
            prefix = key[:-len(".weight_v")]
            out[prefix + ".weight"] = fold_weight_norm(
                value, np.asarray(state_dict[prefix + ".weight_g"]))
        elif not key.endswith(".weight_g"):
            out[key] = value
    return out
