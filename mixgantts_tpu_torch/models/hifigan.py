"""HiFi-GAN generator (`mixgantts_tpu/models/hifigan.py`), V1 and any
other dilation schedule.

conv_pre (k7) -> per stage [leaky_relu -> ConvTranspose1d -> MRF stage] ->
leaky_relu -> conv_post (k7) -> tanh.  The module tree follows the torch
HiFi-GAN key layout (`conv_pre`, `ups.{i}`, `resblocks.{i*n_k+j}.convs1.{c}`,
`convs2.{c}`, `conv_post`) with plain `.weight`s: weight norm is folded
when a checkpoint is loaded.

The MRF stages run in `ops.mrf`: the hand-written CUDA kernel for CUDA
tensors, the plain version for CPU tensors.  Their weights are stacked once
per stage, in bf16 and the kernel's layout on CUDA (the kernel's operand
type, and the TPU kernel's), in fp32 elsewhere (`HiFiGANGenerator.mrf_dtype`
overrides).  The upsample is
`F.conv_transpose1d(stride=u, padding=(k-u)//2)`, which is exactly the JAX
package's sub-pixel upsample.

The kernels share one dilation schedule across the branches of a stage
(true of V1).  A config whose branches have different
`resblock_dilation_sizes` takes the eager route (`eager_apply`: plain
convolutions per branch, the math of the flax `HiFiGANGenerator`), chosen
from the config when the generator is built, as the JAX package's
`Vocoder.apply_fn` chooses.

The generator computes in its parameters' type: the upsample convs, the
activations and conv_post in bf16 for a bf16 copy (the JAX package's
`fused_apply` with `compute_dtype` bf16), tanh and the waveform in fp32.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mrf import (
    LRELU_SLOPE, kernel_weights, mrf_stack, mrf_stack_folded, stack_mrf_params,
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
        # the kernels' route takes one dilation schedule for all branches
        self.kernel_route = len(set(self.resblock_dilation_sizes)) == 1
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
        # type of the MRF weights, and so of the MRF arithmetic: None is
        # bf16 on CUDA (the only type the kernel takes) and fp32 elsewhere
        self.mrf_dtype = None
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
        """mel [B, T, n_mels] log-mel -> waveform [B, T * prod(rates)], fp32."""
        return fused_apply(self, mel) if self.kernel_route else eager_apply(self, mel)


def stage_mode(channels, frames):
    """How a stage's MRF runs, as in the JAX `fused_apply`: time-folded for
    C <= 64 (F = 128 / C) when F divides the frames, whole-stage for
    C <= 128, one call per branch above."""
    fold = 128 // channels if channels < 128 and 128 % channels == 0 else 0
    if fold and channels <= 64 and frames % fold == 0:
        return "folded"
    return "whole" if channels <= 128 else "branchwise"


def stage_weights(generator, stage, mode, channels, dtype=torch.float32):
    """The stacked MRF weights of one stage for `mode`: a dict, or one per
    branch for "branchwise"; in bf16 with the kernel's layout
    (`ops.mrf.kernel_weights`) when dtype is bf16."""
    rks = generator.resblock_kernel_sizes
    dils = generator.resblock_dilation_sizes[0]

    def typed(st, kernel_sizes):
        return kernel_weights(st, kernel_sizes) if dtype == torch.bfloat16 else st

    if mode == "branchwise":
        return [typed(stack_mrf_params(generator, stage, (rk,), dils, branches=[(j, rk)]), (rk,))
                for j, rk in enumerate(rks)]
    if mode == "folded":
        return typed(stack_mrf_params_folded(generator, stage, 128 // channels, rks, dils), rks)
    return typed(stack_mrf_params(generator, stage, rks, dils), rks)


def _generate(generator, mel, mrf_stage):
    """conv_pre -> per stage [leaky_relu -> upsample -> mrf_stage(i, x)] ->
    leaky_relu -> conv_post -> tanh, with x [B, C, T] in the parameters'
    type and tanh in fp32.  mel [B, T, n_mels] -> [B, T * hop] fp32."""
    x = generator.conv_pre(mel.transpose(1, 2).to(generator.conv_pre.weight.dtype))
    for i, up in enumerate(generator.ups):
        x = mrf_stage(i, up(F.leaky_relu(x, LRELU_SLOPE)))
    x = generator.conv_post(F.leaky_relu(x, LRELU_SLOPE))
    return torch.tanh(x.float())[:, 0]


def eager_apply(generator, mel):
    """HiFi-GAN forward with each MRF branch as plain convolutions (any
    dilation schedule), the math of the flax `HiFiGANGenerator.__call__`.
    mel [B, T, n_mels] -> [B, T * hop]."""
    n_k = len(generator.resblock_kernel_sizes)

    def stage(i, x):
        acc = None
        for block in generator.resblocks[i * n_k:(i + 1) * n_k]:
            y = x
            for conv1, conv2 in zip(block.convs1, block.convs2):
                y = y + conv2(F.leaky_relu(conv1(F.leaky_relu(y, LRELU_SLOPE)), LRELU_SLOPE))
            acc = y if acc is None else acc + y
        return acc / n_k

    return _generate(generator, mel, stage)


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
            f"branch, got {dils}; eager_apply takes them")
    dils = dils[0]
    if generator._stacked is None:
        generator._stacked = {}
    # bf16 stacks with the kernel's layout on CUDA; fp32 elsewhere, where the
    # stack keeps the parameters' own type (bf16 ones: bf16 arithmetic)
    dtype = generator.mrf_dtype or (
        torch.bfloat16 if mel.device.type == "cuda" else torch.float32)

    def stage(i, x):
        B, C, T = x.shape
        mode = stage_mode(C, T)
        if (i, mode, dtype) not in generator._stacked:
            generator._stacked[i, mode, dtype] = stage_weights(generator, i, mode, C, dtype)
        stacked = generator._stacked[i, mode, dtype]
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
        return x.transpose(1, 2)

    return _generate(generator, mel, stage)


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
