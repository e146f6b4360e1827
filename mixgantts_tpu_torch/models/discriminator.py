"""JCU (joint conditional and unconditional) discriminator
(`mixgantts_tpu/models/discriminator.py`), channel-last [B, T, C].

A shared trunk of strided convolutions over concat(x_{t-1}, x_t), then a
conditional branch (plus the diffusion-step embedding and, for a
multi-speaker model, the projected speaker embedding) and an
unconditional one.  Each returns the activation of every layer for feature
matching, the logits last.  The module tree has the reference's key layout
(`input_projection`, `mlp`, `conv_block`, `cond_conv_block`,
`uncond_conv_block`, `spk_mlp`), which `mixgantts_tpu/convert.py` reads and
`mixgantts_tpu_torch/convert.py::discriminator_state_dict` writes.
"""

import torch
import torch.nn as nn

from ..utils.tools import resolve_device
from .blocks import ConvNorm, LinearNorm, Mish, diffusion_embedding
from .initializers import init_like_jax


def leaky_relu(x, slope=0.2):
    """jax.nn.leaky_relu, whose gradient at 0 is 1 (torch's is the slope):
    padded frames give exact zeros at the first layer while its bias is 0."""
    return torch.where(x >= 0, x, slope * x)


class JCUDiscriminator(nn.Module):
    def __init__(self, n_mels=80, residual_channels=256, n_layer=3, n_uncond_layer=2,
                 n_cond_layer=2, n_channels=(64, 128, 512, 128, 1),
                 kernel_sizes=(3, 5, 5, 5, 3), strides=(1, 2, 2, 1, 1),
                 multi_speaker=False, speaker_dim=256, device=None):
        super().__init__()
        C = residual_channels
        self.residual_channels = C
        self.multi_speaker = multi_speaker
        self.input_projection = LinearNorm(2 * n_mels, 2 * n_mels)
        self.mlp = nn.Sequential(LinearNorm(C, 4 * C), Mish(),
                                 LinearNorm(4 * C, n_channels[n_layer - 1]))

        def conv(i, c_in):
            return ConvNorm(c_in, n_channels[i], kernel_sizes[i], stride=strides[i])

        self.conv_block = nn.ModuleList(
            conv(i, 2 * n_mels if i == 0 else n_channels[i - 1]) for i in range(n_layer))
        self.cond_conv_block = nn.ModuleList(
            conv(j, n_channels[j - 1]) for j in range(n_layer, n_layer + n_cond_layer))
        self.uncond_conv_block = nn.ModuleList(
            conv(j, n_channels[j - 1]) for j in range(n_layer, n_layer + n_uncond_layer))
        if multi_speaker:
            self.spk_mlp = nn.Sequential(LinearNorm(speaker_dim, n_channels[n_layer - 1]))
        init_like_jax(self)
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_like_jax(self, generator=None):
        """The JAX package's convolution init: normal(0.02), zero bias."""
        for block in (self.conv_block, self.cond_conv_block, self.uncond_conv_block):
            for m in block:
                nn.init.normal_(m.conv.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.conv.bias)

    @classmethod
    def from_configs(cls, preprocess_config, model_config, device=None):
        """Build from the preprocess and model YAML configs."""
        d = model_config["discriminator"]
        return cls(
            n_mels=preprocess_config["preprocessing"]["mel"]["n_mel_channels"],
            residual_channels=model_config["denoiser"]["residual_channels"],
            n_layer=d["n_layer"], n_uncond_layer=d["n_uncond_layer"],
            n_cond_layer=d["n_cond_layer"], n_channels=tuple(d["n_channels"]),
            kernel_sizes=tuple(d["kernel_sizes"]), strides=tuple(d["strides"]),
            multi_speaker=model_config["multi_speaker"],
            speaker_dim=model_config["transformer"]["encoder_hidden"], device=device)

    def forward(self, x_ts, x_t_prevs, spk_emb, t):
        """x_ts, x_t_prevs [B, T, n_mels]; spk_emb [B, H] or None; t [B]
        int diffusion steps.  Returns (cond_feats, uncond_feats), lists of
        [B, T', C'] activations, the logits last."""
        x = self.input_projection(torch.cat([x_t_prevs, x_ts], dim=-1))
        step = self.mlp(diffusion_embedding(t, self.residual_channels))[:, None, :]
        cond_feats, uncond_feats = [], []
        for conv in self.conv_block:
            x = leaky_relu(conv(x))
            cond_feats.append(x)
            uncond_feats.append(x)
        x_cond = x + step
        if self.multi_speaker and spk_emb is not None:
            x_cond = x_cond + self.spk_mlp(spk_emb)[:, None, :]
        x_uncond = x
        for conv in self.cond_conv_block:
            x_cond = leaky_relu(conv(x_cond))
            cond_feats.append(x_cond)
        for conv in self.uncond_conv_block:
            x_uncond = leaky_relu(conv(x_uncond))
            uncond_feats.append(x_uncond)
        return cond_feats, uncond_feats
