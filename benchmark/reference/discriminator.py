"""The plain JCU discriminator (joint conditional and unconditional): a
strided conv trunk over concat(x_{t-1}, x_t), then a conditional branch
(plus the diffusion-step embedding) and an unconditional one; each returns
every layer's activation, the logits last."""

import torch
import torch.nn as nn

from .blocks import ConvNorm, LinearNorm, Mish, diffusion_embedding


def leaky_relu(x, slope=0.2):
    """Gradient 1 at 0, as jax.nn.leaky_relu."""
    return torch.where(x >= 0, x, slope * x)


class JCUDiscriminator(nn.Module):
    def __init__(self, n_mels, residual_channels, cfg):
        super().__init__()
        C = residual_channels
        n_layer, n_ch = cfg["n_layer"], cfg["n_channels"]
        ks, strides = cfg["kernel_sizes"], cfg["strides"]
        self.C = C
        self.input_projection = LinearNorm(2 * n_mels, 2 * n_mels)
        self.mlp = nn.Sequential(LinearNorm(C, 4 * C), Mish(), LinearNorm(4 * C, n_ch[n_layer - 1]))

        def conv(i, c_in):
            return ConvNorm(c_in, n_ch[i], ks[i], stride=strides[i])

        self.conv_block = nn.ModuleList(
            conv(i, 2 * n_mels if i == 0 else n_ch[i - 1]) for i in range(n_layer))
        self.cond_conv_block = nn.ModuleList(
            conv(j, n_ch[j - 1]) for j in range(n_layer, n_layer + cfg["n_cond_layer"]))
        self.uncond_conv_block = nn.ModuleList(
            conv(j, n_ch[j - 1]) for j in range(n_layer, n_layer + cfg["n_uncond_layer"]))

    def forward(self, x_ts, x_t_prevs, t):
        x = self.input_projection(torch.cat([x_t_prevs, x_ts], dim=-1))
        step = self.mlp(diffusion_embedding(t, self.C))[:, None, :]
        cond_feats, uncond_feats = [], []
        for conv in self.conv_block:
            x = leaky_relu(conv(x))
            cond_feats.append(x)
            uncond_feats.append(x)
        x_cond, x_uncond = x + step, x
        for conv in self.cond_conv_block:
            x_cond = leaky_relu(conv(x_cond))
            cond_feats.append(x_cond)
        for conv in self.uncond_conv_block:
            x_uncond = leaky_relu(conv(x_uncond))
            uncond_feats.append(x_uncond)
        return cond_feats, uncond_feats
