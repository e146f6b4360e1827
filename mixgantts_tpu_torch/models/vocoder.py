"""Vocoder loading (`mixgantts_tpu/models/vocoder.py`), HiFi-GAN only.

`get_vocoder` returns the configured generator: loaded natively from
`generator_{speaker}.pth.tar` (weight norm folded) when that file exists,
otherwise a random init, seeded, that honours `num_mels`.
"""

import json
import os
from dataclasses import dataclass
from typing import Any

import torch

from .hifigan import HiFiGANGenerator, plain_state_dict

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_HIFIGAN_CONFIG = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "num_mels": 80,
}


@dataclass
class Vocoder:
    name: str             # 'HiFi-GAN'
    generator: Any        # HiFiGANGenerator
    config: dict

    def __call__(self, mel):
        """mel [B, T, n_mels] log-mel -> waveform [B, T * hop] in [-1, 1]."""
        return self.generator(mel)


def get_vocoder(model_config, ckpt_dir=None, num_mels=None, device=None, seed=0):
    """Build the configured vocoder on `device` (default cuda).  `num_mels`
    sets the input channels when no vocoder config.json is present; `seed`
    makes the random init reproducible when no checkpoint is."""
    name = model_config["vocoder"]["model"]
    if name == "MelGAN":
        raise NotImplementedError("the MelGAN vocoder is not ported yet")
    if name != "HiFi-GAN":
        raise ValueError(f"unknown vocoder {name!r}")
    if ckpt_dir is None:
        ckpt_dir = os.path.join(_REPO_DIR, "vocoder_ckpt")
    config = dict(DEFAULT_HIFIGAN_CONFIG)
    cfg_path = os.path.join(ckpt_dir, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            config.update(json.load(f))
    elif num_mels is not None:
        config["num_mels"] = num_mels
    ckpt_path = os.path.join(ckpt_dir, f"generator_{model_config['vocoder']['speaker']}.pth.tar")
    with torch.random.fork_rng(devices=[]):  # parameters are made on the CPU
        torch.default_generator.manual_seed(seed)
        generator = HiFiGANGenerator.from_config(config, device=device)
    if os.path.isfile(ckpt_path):
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "generator" in ckpt:
            ckpt = ckpt["generator"]
        sd = plain_state_dict({k: v.numpy() for k, v in ckpt.items()})
        generator.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return Vocoder(name, generator, config)
