"""The plain HiFi-GAN generator (jik876/hifi-gan, weight norm folded):
conv_pre (k7) -> per stage [leaky_relu -> ConvTranspose1d -> MRF] ->
leaky_relu -> conv_post (k7) -> tanh.

The MRF stage (per branch of kernel k, residual pairs leaky_relu ->
dilated conv -> leaky_relu -> conv; the mean of the branches) runs in the
kernels' arithmetic of `arith`: the stage input and every conv input
rounded to the operand type, products summed in float32, biases, residual
and branch mean in float32.  Everything else is float32.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .arith import FULL

LRELU_SLOPE = 0.1


class ResBlock1(nn.Module):
    def __init__(self, channels, kernel_size, dilations):
        super().__init__()
        k = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d, padding=d * (k - 1) // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, k, padding=(k - 1) // 2)
                                    for _ in dilations)

    def forward(self, x, arith):
        y = x
        for c1, c2 in zip(self.convs1, self.convs2):
            t = F.conv1d(arith.operand(F.leaky_relu(y, LRELU_SLOPE)), arith.operand(c1.weight),
                         None, dilation=c1.dilation, padding=c1.padding)
            t = t + c1.bias[:, None]
            t = F.conv1d(arith.operand(F.leaky_relu(t, LRELU_SLOPE)), arith.operand(c2.weight),
                         None, padding=c2.padding)
            y = y + (t + c2.bias[:, None])
        return y


class HiFiGAN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c0 = cfg["upsample_initial_channel"]
        self.n_k = len(cfg["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(cfg["num_mels"], c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2))
            for rk, rd in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel, arith=FULL):
        """mel [B, T, n_mels] -> waveform [B, T * hop] in [-1, 1]."""
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = arith.operand(x)
            acc = None
            for block in self.resblocks[i * self.n_k:(i + 1) * self.n_k]:
                y = block(xs, arith)
                acc = y if acc is None else acc + y
            x = acc / self.n_k
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x)[:, 0]


def to_int16(wave, max_wav_value):
    """The served waveform: scaled, clamped and truncated to int16."""
    return torch.clamp(wave * max_wav_value, -max_wav_value, max_wav_value - 1).to(torch.int16)
