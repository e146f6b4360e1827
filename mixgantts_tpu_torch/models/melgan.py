"""MelGAN generator (`mixgantts_tpu/models/melgan.py`), the
descript/melgan-neurips architecture: ngf 32, 3 residual layers, ratios
8/8/2/2.

One `nn.Sequential` named `model`, with the descript module indices
(reflection pad, conv_in at `model.1`, per ratio a leaky_relu, the
transposed conv and the residual blocks, then leaky_relu, reflection pad and
conv_out; descript's last module, tanh, has no parameters and runs after
the sequence in fp32), so that a descript state_dict loads natively once its
weight norm is folded (`hifigan.plain_state_dict`).  Plain PyTorch: the JAX
package has no kernel for it.  The generator computes in its parameters'
type.
"""

import torch
import torch.nn as nn

from ..utils.tools import resolve_device


class ResnetBlock(nn.Module):
    """leaky_relu -> reflect-padded dilated k = 3 conv -> leaky_relu -> 1x1
    conv, plus a 1x1 shortcut."""

    def __init__(self, dim, dilation):
        super().__init__()
        self.block = nn.Sequential(
            nn.LeakyReLU(0.2), nn.ReflectionPad1d(dilation),
            nn.Conv1d(dim, dim, 3, dilation=dilation), nn.LeakyReLU(0.2),
            nn.Conv1d(dim, dim, 1))
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


class MelGANGenerator(nn.Module):
    def __init__(self, n_mels=80, ngf=32, n_residual_layers=3, ratios=(8, 8, 2, 2),
                 device=None):
        super().__init__()
        device = resolve_device(device)
        mult = 2 ** len(ratios)
        layers = [nn.ReflectionPad1d(3), nn.Conv1d(n_mels, mult * ngf, 7)]
        for r in ratios:
            # output length T * r: padding r // 2 + r % 2, output_padding r % 2
            layers += [nn.LeakyReLU(0.2),
                       nn.ConvTranspose1d(mult * ngf, mult * ngf // 2, 2 * r, stride=r,
                                          padding=r // 2 + r % 2, output_padding=r % 2)]
            layers += [ResnetBlock(mult * ngf // 2, 3 ** j) for j in range(n_residual_layers)]
            mult //= 2
        layers += [nn.LeakyReLU(0.2), nn.ReflectionPad1d(3), nn.Conv1d(ngf, 1, 7)]
        self.model = nn.Sequential(*layers)
        self.to(device)

    def forward(self, mel):
        """mel [B, T, n_mels] -> waveform [B, T * prod(ratios)], fp32."""
        x = self.model(mel.transpose(1, 2).to(self.model[1].weight.dtype))
        return torch.tanh(x.float())[:, 0]
