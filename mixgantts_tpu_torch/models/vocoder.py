"""Vocoder loading and mel -> waveform inference
(`mixgantts_tpu/models/vocoder.py`): HiFi-GAN and MelGAN.

`get_vocoder` returns the configured generator, loaded natively (weight
norm folded) from its checkpoint when the file exists, otherwise a random
init, seeded, that honours `num_mels`:
- HiFi-GAN: `generator_{speaker}.pth.tar` and `config.json`;
- MelGAN (descript/melgan-neurips, 80 mels): `melgan_generator.pt`.
A checkpoint may hold a state_dict, a dict with "generator", or a pickled
module (read through its `state_dict()`).  `vocoder_infer` turns a mel
batch into trimmed int16 waveforms.
"""

import json
import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .hifigan import HiFiGANGenerator, plain_state_dict
from .melgan import MelGANGenerator

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
    name: str             # 'HiFi-GAN' | 'MelGAN'
    generator: Any        # HiFiGANGenerator | MelGANGenerator
    config: dict = None   # HiFi-GAN's config

    def __call__(self, mel):
        """mel [B, T, n_mels] log-mel -> waveform [B, T * hop] in [-1, 1],
        fp32.  MelGAN's input is scaled by 1 / ln 10, as in the reference."""
        if self.name == "MelGAN":
            mel = mel * (1.0 / math.log(10.0))
        return self.generator(mel)


def _load_state_dict(path):
    """A vocoder checkpoint -> {key: tensor} with weight norm folded."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "generator" in ckpt:
        ckpt = ckpt["generator"]
    if hasattr(ckpt, "state_dict"):   # a pickled module
        ckpt = ckpt.state_dict()
    sd = plain_state_dict({k: v.detach().cpu().numpy() for k, v in ckpt.items()})
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def get_vocoder(model_config, ckpt_dir=None, num_mels=None, device=None, seed=0):
    """Build the configured vocoder on `device` (default cuda).  `num_mels`
    sets the input channels of a random init (HiFi-GAN: when no config.json
    is present); `seed` makes the random init reproducible."""
    name = model_config["vocoder"]["model"]
    if name not in ("HiFi-GAN", "MelGAN"):
        raise ValueError(f"unknown vocoder {name!r}")
    if ckpt_dir is None:
        ckpt_dir = os.path.join(_REPO_DIR, "vocoder_ckpt")
    config = None
    if name == "HiFi-GAN":
        config = dict(DEFAULT_HIFIGAN_CONFIG)
        cfg_path = os.path.join(ckpt_dir, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                config.update(json.load(f))
        elif num_mels is not None:
            config["num_mels"] = num_mels
        ckpt_path = os.path.join(ckpt_dir, f"generator_{model_config['vocoder']['speaker']}.pth.tar")

        def build():
            return HiFiGANGenerator.from_config(config, device=device)
    else:
        ckpt_path = os.path.join(ckpt_dir, "melgan_generator.pt")
        # the descript weights are 80-mel; a random init honours num_mels
        n_mels = 80 if os.path.isfile(ckpt_path) else (num_mels or 80)

        def build():
            return MelGANGenerator(n_mels=n_mels, device=device)
    with torch.random.fork_rng(devices=[]):  # parameters are made on the CPU
        torch.default_generator.manual_seed(seed)
        generator = build()
    if os.path.isfile(ckpt_path):
        generator.load_state_dict(_load_state_dict(ckpt_path))
    return Vocoder(name, generator, config)


def vocoder_infer(mels, vocoder, preprocess_config, lengths=None):
    """mel batch [B, T, n_mels] (a tensor on the vocoder's device) -> list
    of int16 numpy waveforms, clipped to [-1, 1], scaled by max_wav_value
    and trimmed to length * hop_length when `lengths` is given."""
    max_wav_value = preprocess_config["preprocessing"]["audio"]["max_wav_value"]
    hop = preprocess_config["preprocessing"]["stft"]["hop_length"]
    with torch.no_grad():
        wavs = vocoder(mels).float().cpu().numpy()
    wavs = (np.clip(wavs, -1.0, 1.0) * max_wav_value).astype(np.int16)
    if lengths is None:
        return list(wavs)
    return [wavs[i, :int(lengths[i]) * hop] for i in range(len(wavs))]
