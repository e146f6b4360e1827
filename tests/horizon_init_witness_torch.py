"""Which initialiser the long-horizon drive's wav bars see.

The port's random inits are torch's defaults; the JAX package's are
flax's.  For the random HiFi-GAN V1 that the synthesis CLI serves when
there is no vocoder checkpoint, every layer of the JAX one takes flax's
defaults: lecun_normal weights (a normal of variance 1 / fan_in, truncated
at two standard deviations) and zero biases, where torch's are
kaiming-uniform weights of variance 1 / (3 fan_in) and uniform biases.
The final checkpoint of a finished drive (`tests/train_horizon_torch.py`)
synthesizes "hello world" once per speaker, with the synthesis CLI's seed,
and the mel is vocoded twice: by the vocoder as the port builds it, and by
the same module re-initialised with flax's defaults (`jax_init`, drawn
from seed 0; `tests/test_torch_init.py` holds its distributions against
the JAX HiFi-GAN's).  Each wav's spectrum (`train_horizon_torch.spectrum`)
is printed beside the drive's bars (interior energy > 0.2, mid and high
bands >= 3%, and for two speakers a mean |delta| > 5% of the amplitude),
as one JSON line.

    python tests/horizon_init_witness_torch.py               # after the aux -> shallow drive
    python tests/horizon_init_witness_torch.py multispeaker  # after the 3-speaker drive

It imports nothing of JAX, flax or `mixgantts_tpu`.
"""

import copy
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import train_horizon_torch as horizon  # noqa: E402  (puts the repo on sys.path)


TRUNCATED_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def jax_init(generator, seed=0):
    """`generator` (a HiFi-GAN) with flax's default initialisers, drawn on
    the CPU from `seed`: every convolution's weight lecun_normal with fan_in
    = weight[0].numel() (in x kernel, and out x kernel for a transposed
    one, whose flax kernel is [k, out, in]), its bias zero.  Returns it."""
    import torch
    import torch.nn as nn
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, m in generator.named_modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            std = m.weight[0].numel() ** -0.5 / TRUNCATED_STD
            w = torch.empty(m.weight.shape)
            state[f"{name}.weight"] = nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                                            generator=g)
            state[f"{name}.bias"] = torch.zeros(m.bias.shape)
    generator.load_state_dict(state)   # every parameter: the convolutions' alone
    return generator


def witness(ws, mode, step, speakers=(0,), device=None):
    """{initialiser: {speaker: spectrum, ["pair_delta_over_amplitude"]}} for the checkpoint
    `step` of `mode` in the drive workspace `ws`."""
    import torch

    from mixgantts_tpu_torch.cli.common import build_model, restore_generator
    from mixgantts_tpu_torch.cli.synthesize import build_single_batch
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.models.vocoder import Vocoder, get_vocoder
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    from mixgantts_tpu_torch.utils.tools import resolve_device

    device = resolve_device(device)
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        pre, cfg, tc = get_configs_of("TestCorpus")
        batches = {spk: build_single_batch(types.SimpleNamespace(text="hello world",
                                                                 speaker_id=spk), pre, cfg)
                   for spk in speakers}
    finally:
        os.chdir(cwd)
    model, _ = build_model(mode, pre, cfg, device=device)
    restore_generator(model, tc["path"]["ckpt_path"] + ("_naive" if mode == "naive"
                                                        else "_shallow"), step)
    vocoder = get_vocoder(cfg, num_mels=pre["preprocessing"]["mel"]["n_mel_channels"],
                          device=device)
    out = {}
    flax_voc = Vocoder(vocoder.name, jax_init(copy.deepcopy(vocoder.generator)), vocoder.config)
    for init, voc in (("torch_default", vocoder), ("jax", flax_voc)):
        pipe = TTSPipeline(model, voc, pre, cfg)
        pcm = {}
        for spk, batch in batches.items():   # the CLI's first batch draws from seed 0
            wavs, _, _ = pipe(batch, generator=torch.Generator(device).manual_seed(0))
            pcm[spk] = wavs[0].astype(np.float32) / 32768.0
        out[init] = {str(spk): horizon.spectrum(p) for spk, p in pcm.items()}
        if len(pcm) == 2:
            a, b = pcm.values()
            n = min(len(a), len(b))
            scale = float(np.abs(a[:n]).mean() + np.abs(b[:n]).mean()) / 2
            out[init]["pair_delta_over_amplitude"] = float(np.abs(a[:n] - b[:n]).mean()) / scale
    return out


def main(argv):
    multispeaker = argv[:1] == ["multispeaker"]
    if argv and not multispeaker:
        sys.exit(f"unknown mode {argv[0]!r} (expected 'multispeaker', or no argument)")
    if multispeaker:
        result = witness(horizon.workspace(True), "naive", horizon.MS_STEPS, speakers=(0, 2))
    else:
        result = witness(horizon.workspace(), "shallow",
                         horizon.AUX_STEPS + horizon.SHALLOW_STEPS)
    print(json.dumps({"witness": "multispeaker" if multispeaker else "aux_shallow",
                      "device": horizon.gpu_line(), **result}))


if __name__ == "__main__":
    main(sys.argv[1:])
