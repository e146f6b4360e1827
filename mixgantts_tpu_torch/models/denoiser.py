"""DiffWave-style conditional denoiser (`mixgantts_tpu/models/denoiser.py`),
channel-last.

The 20 gated residual blocks run as one call of
`ops.denoiser_stack.fused_residual_stack`: the hand-written bf16
tensor-core kernel for CUDA tensors, its plain PyTorch version for CPU
tensors.  Their weights are stacked once, in bf16 with the kernel's layout
on CUDA (the kernel's operand type, and the TPU kernel's), in the
parameters' own type elsewhere (`Denoiser.stack_dtype` overrides).  (The
JAX package takes its TPU kernel only at batch >= 2; that rule was
measured on a TPU and is not carried over.)
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.denoiser_stack import (
    denoiser_kernel_weights, fused_residual_stack, stack_denoiser_params,
)
from .blocks import ConvNorm, LinearNorm, Mish, diffusion_embedding


class ResidualBlock(nn.Module):
    """Parameters of one gated residual block; the stack's math is in
    `ops.denoiser_stack`."""

    def __init__(self, d_encoder, residual_channels):
        super().__init__()
        C = residual_channels
        self.conv_layer = ConvNorm(C, 2 * C, 3)
        self.diffusion_projection = LinearNorm(C, C)
        self.conditioner_projection = ConvNorm(d_encoder, C, 1)
        self.output_projection = ConvNorm(C, 2 * C, 1)


class Denoiser(nn.Module):
    def __init__(self, n_mels=80, d_encoder=256, residual_channels=256,
                 residual_layers=20):
        super().__init__()
        C = residual_channels
        self.residual_channels = C
        self.input_projection = nn.Sequential(ConvNorm(n_mels, C, 1), nn.ReLU())
        self.mlp = nn.Sequential(LinearNorm(C, 4 * C), Mish(), LinearNorm(4 * C, C))
        self.residual_layers = nn.ModuleList(
            ResidualBlock(d_encoder, C) for _ in range(residual_layers))
        self.skip_projection = ConvNorm(C, C, 1)
        self.output_projection = ConvNorm(C, n_mels, 1)
        nn.init.zeros_(self.output_projection.conv.weight)  # as the reference
        self._stacked = None
        # type of the stack's conv and output weights, and so of its
        # arithmetic: None is bf16 on CUDA (the only type the kernel takes)
        # and the parameters' type elsewhere
        self.stack_dtype = None

    def stacked(self):
        """The residual blocks' weights stacked for `fused_residual_stack`
        in the type `stack_dtype` resolves to (bf16: with the kernel's
        layout, `denoiser_kernel_weights`), built once and rebuilt after
        `load_state_dict`, a move to another device or another type."""
        w = self.input_projection[0].conv.weight
        dtype = self.stack_dtype or (torch.bfloat16 if w.device.type == "cuda" else w.dtype)
        if dtype not in (torch.bfloat16, w.dtype):
            raise ValueError(f"Denoiser.stack_dtype {dtype}: bf16 or the parameters' "
                             f"{w.dtype}")
        if self._stacked is None or self._stacked[0] != dtype:
            st = stack_denoiser_params(self)
            self._stacked = (dtype, denoiser_kernel_weights(st) if dtype == torch.bfloat16 else st)
        return self._stacked[1]

    def _apply(self, fn, *args, **kwargs):
        self._stacked = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._stacked = None
        super()._load_from_state_dict(*args, **kwargs)

    def forward(self, x_t, t, cond):
        """x_t [B, T, n_mels] noisy mel, t [B] int diffusion step, cond
        [B, T, H] -> x0 prediction [B, T, n_mels]."""
        x = self.input_projection(x_t)
        step_emb = self.mlp(diffusion_embedding(t, self.residual_channels))
        _, skip_sum = fused_residual_stack(x, cond, step_emb, self.stacked())
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = F.relu(self.skip_projection(x))
        return self.output_projection(x)
