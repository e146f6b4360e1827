"""DiffWave-style conditional denoiser (`mixgantts_tpu/models/denoiser.py`),
channel-last.

The 20 gated residual blocks run as one call of
`ops.denoiser_stack.fused_residual_stack`: the hand-written bf16
tensor-core kernel for CUDA tensors (any `residual_channels` up to 256),
its plain PyTorch version for CPU tensors.  Their weights are stacked once, in bf16 with the kernel's layout
on CUDA (the kernel's operand type, and the TPU kernel's), in the
parameters' own type elsewhere (`Denoiser.stack_dtype` overrides).  (The
JAX package takes its TPU kernel only at batch >= 2; that rule was
measured on a TPU and is not carried over.)

A multi-speaker denoiser adds each block's speaker projection of the
speaker embedding to y (never to the residual), as the JAX package's flax
blocks do; here it rides in the kernel's conditioner projection
(`speaker_projections`), so the same kernel runs with or without it.  The
JAX package leaves its TPU kernel for the flax blocks when a speaker
embedding is present.

Training takes the blocks one by one on their live parameters
(`ResidualBlock.forward`, the flax blocks' math in fp32), as the JAX
package's training does: the kernel has no backward, and its weights are
detached bf16 copies.  `Denoiser.forward` takes that route whenever
autograd records the stack or the caller asks for it (`fused=False`, the
generator's training branch).  Under tensor parallelism (`parallel.tp`)
the blocks' convs are row-parallel over the residual channels; only
training runs sharded blocks, so the kernel always sees whole weights.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.denoiser_stack import (
    denoiser_kernel_weights, fused_residual_stack, speaker_projections,
    stack_denoiser_params,
)
from ..parallel.collectives import scatter_to_model
from .blocks import ConvNorm, LinearNorm, Mish, diffusion_embedding, row_parallel


class ResidualBlock(nn.Module):
    """One gated residual block.  Inference stacks the blocks' parameters
    for `ops.denoiser_stack`; `forward` is the block alone, for training."""

    def __init__(self, d_encoder, residual_channels, multi_speaker=False):
        super().__init__()
        C = residual_channels
        self.conv_layer = ConvNorm(C, 2 * C, 3)
        self.diffusion_projection = LinearNorm(C, C)
        self.conditioner_projection = ConvNorm(d_encoder, C, 1)
        self.output_projection = ConvNorm(C, 2 * C, 1)
        if multi_speaker:
            self.speaker_projection = LinearNorm(d_encoder, C)

    def forward(self, x, cond, step_emb, spk_emb=None):
        """x [B, T, C], cond [B, T, H], step_emb [B, C], spk_emb [B, H] or
        None -> (residual output [B, T, C], skip [B, T, C])."""
        y0 = x + self.diffusion_projection(step_emb)[:, None, :]
        y = y0 + self.conditioner_projection(cond)
        if spk_emb is not None:
            y = y + self.speaker_projection(spk_emb)[:, None, :]
        if self.conv_layer.conv.weight.shape[1] != self.conv_layer.conv.in_channels:
            # row-parallel over the residual channels (parallel.tp): each rank
            # contracts its channels of y and of g, the partial 2C outputs
            # are all-reduced and the biases added once
            gate, filt = row_parallel(self.conv_layer.conv, scatter_to_model(y)).chunk(2, dim=-1)
            g = scatter_to_model(torch.sigmoid(gate) * torch.tanh(filt))
            out, skip = row_parallel(self.output_projection.conv, g).chunk(2, dim=-1)
        else:
            gate, filt = self.conv_layer(y).chunk(2, dim=-1)
            out, skip = self.output_projection(
                torch.sigmoid(gate) * torch.tanh(filt)).chunk(2, dim=-1)
        return (out + y0) / math.sqrt(2.0), skip


class Denoiser(nn.Module):
    def __init__(self, n_mels=80, d_encoder=256, residual_channels=256,
                 residual_layers=20, multi_speaker=False):
        super().__init__()
        C = residual_channels
        self.residual_channels = C
        self.multi_speaker = multi_speaker
        self.input_projection = nn.Sequential(ConvNorm(n_mels, C, 1), nn.ReLU())
        self.mlp = nn.Sequential(LinearNorm(C, 4 * C), Mish(), LinearNorm(4 * C, C))
        self.residual_layers = nn.ModuleList(
            ResidualBlock(d_encoder, C, multi_speaker) for _ in range(residual_layers))
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

    def forward(self, x_t, t, cond, spk_emb=None, fused=True):
        """x_t [B, T, n_mels] noisy mel, t [B] int diffusion step, cond
        [B, T, H], spk_emb [B, H] (used by a multi-speaker denoiser) -> x0
        prediction [B, T, n_mels], in the parameters' type.  The residual
        stack runs through `fused_residual_stack` when `fused` and autograd
        does not record it, else block by block."""
        x = self.input_projection(x_t)
        step_emb = self.mlp(diffusion_embedding(t, self.residual_channels))
        spk_emb = spk_emb if self.multi_speaker else None
        records = torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in
            (x, cond, step_emb, spk_emb, self.residual_layers[0].conv_layer.conv.weight))
        if fused and not records:
            stacked = self.stacked()
            spk_proj = None if spk_emb is None else speaker_projections(spk_emb, stacked)
            _, skip_sum = fused_residual_stack(x, cond.to(x.dtype), step_emb, stacked, spk_proj)
        else:
            # the weights are about to move: drop the stack cached for the kernel
            self._stacked = None
            skip_sum = 0
            for block in self.residual_layers:
                x, skip = block(x, cond, step_emb, spk_emb)
                skip_sum = skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = F.relu(self.skip_projection(x))
        return self.output_projection(x)
