"""The port's vocoders against the JAX package on the CPU.

- MelGAN (descript/melgan-neurips): the port's generator against the flax
  `MelGANGenerator` through `convert.melgan_state_dict`, and against the
  descript oracle that tests/test_melgan.py builds (copied here) loaded
  natively, weight norm folded: rtol 1e-4, atol 1e-5.
- `get_vocoder`'s MelGAN: the seeded random init honours `num_mels`; a
  `melgan_generator.pt` loads; `Vocoder.__call__` applies the 1/ln 10 input
  scale, as the JAX `Vocoder` does (same tolerance); `vocoder_infer`
  clips, converts to int16 and trims as the JAX function does (int16
  within 1 LSB).
- A vocoder checkpoint that pickles the whole generator module loads
  through its `state_dict()`, and gives the JAX package's waveform for the
  same file (rtol 1e-4, atol 1e-5).
- bf16: the port's HiFi-GAN computing in bf16 (parameters cast as the
  pipeline casts them) against its fp32 self on the same mel: SNR > 30 dB
  (the JAX package's bar for its bf16 vocoder, tests/test_vocoder.py).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.models.melgan import MelGANGenerator as JMelGAN
from mixgantts_tpu.models.vocoder import get_vocoder as j_get_vocoder
from mixgantts_tpu.models.vocoder import vocoder_infer as j_vocoder_infer
from mixgantts_tpu_torch.convert import melgan_state_dict
from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator, plain_state_dict
from mixgantts_tpu_torch.models.melgan import MelGANGenerator
from mixgantts_tpu_torch.models.vocoder import DEFAULT_HIFIGAN_CONFIG, get_vocoder, vocoder_infer
from mixgantts_tpu_torch.pipeline import cast_parameters
from test_vocoder import SMALL_CONFIG
from torch_port_helpers import assert_close, numpy_tree, t

MELGAN = {"model": "MelGAN", "speaker": "universal"}


def build_torch_melgan(n_mels, ngf, n_residual_layers, ratios):
    """descript/melgan-neurips mel2wav/modules.py Generator, verbatim
    architecture (weight-normed convs in one flat nn.Sequential), as
    tests/test_melgan.py builds it."""
    import torch.nn as nn
    from torch.nn.utils import weight_norm

    def WNConv1d(*a, **k):
        return weight_norm(nn.Conv1d(*a, **k))

    def WNConvTranspose1d(*a, **k):
        return weight_norm(nn.ConvTranspose1d(*a, **k))

    class ResnetBlock(nn.Module):
        def __init__(self, dim, dilation=1):
            super().__init__()
            self.block = nn.Sequential(
                nn.LeakyReLU(0.2),
                nn.ReflectionPad1d(dilation),
                WNConv1d(dim, dim, kernel_size=3, dilation=dilation),
                nn.LeakyReLU(0.2),
                WNConv1d(dim, dim, kernel_size=1),
            )
            self.shortcut = WNConv1d(dim, dim, kernel_size=1)

        def forward(self, x):
            return self.shortcut(x) + self.block(x)

    class Generator(nn.Module):
        def __init__(self):
            super().__init__()
            mult = int(2 ** len(ratios))
            model = [nn.ReflectionPad1d(3),
                     WNConv1d(n_mels, mult * ngf, kernel_size=7, padding=0)]
            for i, r in enumerate(ratios):
                model += [nn.LeakyReLU(0.2),
                          WNConvTranspose1d(mult * ngf, mult * ngf // 2,
                                            kernel_size=r * 2, stride=r,
                                            padding=r // 2 + r % 2,
                                            output_padding=r % 2)]
                for j in range(n_residual_layers):
                    model += [ResnetBlock(mult * ngf // 2, dilation=3 ** j)]
                mult //= 2
            model += [nn.LeakyReLU(0.2), nn.ReflectionPad1d(3),
                      WNConv1d(ngf, 1, kernel_size=7, padding=0), nn.Tanh()]
            self.model = nn.Sequential(*model)

        def forward(self, x):
            return self.model(x)

    return Generator()


def mel_batch(n_mels, T=17, seed=1):
    return np.random.RandomState(seed).randn(2, T, n_mels).astype(np.float32)


@pytest.mark.parametrize("ratios,nres", [((8, 8, 2, 2), 3), ((4, 2), 2)])
def test_melgan_matches_flax(ratios, nres):
    """The flax tree through `melgan_state_dict`, loaded strictly."""
    n_mels, ngf = 20, 8
    module = JMelGAN(n_mels=n_mels, ngf=ngf, n_residual_layers=nres, ratios=ratios)
    mel = mel_batch(n_mels)
    params = numpy_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(mel))["params"])
    want = jax.jit(module.apply)({"params": params}, jnp.asarray(mel))
    port = MelGANGenerator(n_mels=n_mels, ngf=ngf, n_residual_layers=nres, ratios=ratios,
                           device="cpu")
    port.load_state_dict(melgan_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(t(mel))
    assert got.shape == want.shape == (2, 17 * int(np.prod(ratios)))
    assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_melgan_matches_descript_oracle():
    """The descript state_dict, weight norm folded, loads natively (key for
    key) and gives the oracle's waveform."""
    n_mels, ngf = 20, 8
    torch.manual_seed(0)
    oracle = build_torch_melgan(n_mels, ngf, 3, (8, 8, 2, 2)).eval()
    mel = mel_batch(n_mels)
    with torch.no_grad():
        want = oracle(t(mel).transpose(1, 2))[:, 0]
    port = MelGANGenerator(n_mels=n_mels, ngf=ngf, device="cpu")
    sd = plain_state_dict({k: v.detach().numpy() for k, v in oracle.state_dict().items()})
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        assert_close(port(t(mel)), want, rtol=1e-4, atol=1e-5)


def test_get_vocoder_melgan_random_init_and_input_scale():
    """A seeded random init with the corpus's mel bins (as the JAX package's
    HiFi-GAN branch honours them); `Vocoder.__call__` divides the mel by
    ln 10 as the JAX `Vocoder` does, on the same weights."""
    a = get_vocoder({"vocoder": MELGAN}, ckpt_dir="/nonexistent", num_mels=20, device="cpu")
    b = get_vocoder({"vocoder": MELGAN}, ckpt_dir="/nonexistent", num_mels=20, device="cpu")
    assert a.name == "MelGAN" and a.generator.model[1].in_channels == 20
    assert all(torch.equal(p, q) for p, q in zip(a.generator.parameters(),
                                                 b.generator.parameters()))
    jvoc = j_get_vocoder({"vocoder": MELGAN}, ckpt_dir="/nonexistent", num_mels=20)
    a.generator.load_state_dict(melgan_state_dict(numpy_tree(jvoc.params)), strict=True)
    mel = mel_batch(20, T=6)
    with torch.no_grad():
        got = a(t(mel))
        unscaled = a.generator(t(mel))
    assert_close(got, jvoc(jnp.asarray(mel)), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        assert_close(got, a.generator(t(mel / math.log(10.0))), rtol=1e-5, atol=1e-6)
    assert (got - unscaled).abs().max() > 1e-3


def test_get_vocoder_loads_melgan_checkpoint_and_vocoder_infer(tmp_path):
    """`melgan_generator.pt` (a descript generator's state_dict) loads as
    80-mel; `vocoder_infer` gives the JAX function's int16 waveforms, clipped
    and trimmed to length * hop."""
    torch.manual_seed(1)
    oracle = build_torch_melgan(80, 32, 3, (8, 8, 2, 2)).eval()
    torch.save(oracle.state_dict(), tmp_path / "melgan_generator.pt")
    voc = get_vocoder({"vocoder": MELGAN}, ckpt_dir=str(tmp_path), num_mels=20, device="cpu")
    jvoc = j_get_vocoder({"vocoder": MELGAN}, ckpt_dir=str(tmp_path), num_mels=20)
    assert voc.generator.model[1].in_channels == 80
    mel = mel_batch(80, T=9, seed=3) * 3.0
    with torch.no_grad():
        want = oracle(t(mel / math.log(10.0)).transpose(1, 2))[:, 0]
        assert_close(voc(t(mel)), want, rtol=1e-4, atol=1e-5)
    pre = {"preprocessing": {"audio": {"max_wav_value": 32768.0}, "stft": {"hop_length": 256}}}
    lengths = [9, 4]
    got = vocoder_infer(t(mel), voc, pre, lengths)
    ref = j_vocoder_infer(mel, jvoc, pre, lengths)
    for g, w, n in zip(got, ref, lengths):
        assert g.dtype == np.int16 and g.shape == w.shape == (n * 256,)
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
    assert [len(w) for w in vocoder_infer(t(mel), voc, pre)] == [9 * 256] * 2


def test_pickled_module_checkpoint_loads(tmp_path):
    """A `generator_{speaker}.pth.tar` holding the whole pickled generator
    (weight-normed convs) loads through `.state_dict()`, as the JAX package
    loads it, and both give the module's own waveform."""
    torch.manual_seed(4)
    module = HiFiGANGenerator.from_config(SMALL_CONFIG, device="cpu")
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(m)
    mel = mel_batch(SMALL_CONFIG["num_mels"], T=11, seed=4)
    with torch.no_grad():
        want = module(t(mel))
    torch.save({"generator": module}, tmp_path / "generator_LJSpeech.pth.tar")
    (tmp_path / "config.json").write_text(json.dumps(SMALL_CONFIG))
    model_config = {"vocoder": {"model": "HiFi-GAN", "speaker": "LJSpeech"}}
    with torch.no_grad():
        got = get_vocoder(model_config, ckpt_dir=str(tmp_path), device="cpu")(t(mel))
    jvoc = j_get_vocoder(model_config, ckpt_dir=str(tmp_path))
    assert_close(got, jvoc.apply_fn(jvoc.params, jnp.asarray(mel)), rtol=1e-4, atol=1e-5)
    assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("config", [
    SMALL_CONFIG,    # C = 8, 4: time-folded stages
    # V1's first two stages: C = 256 one call per branch, C = 128 whole
    dict(DEFAULT_HIFIGAN_CONFIG, num_mels=20, upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4]),
])
def test_hifigan_bf16_snr(config):
    torch.manual_seed(0)
    gen = HiFiGANGenerator.from_config(config, device="cpu")
    low = cast_parameters(gen, torch.bfloat16)
    mel = t(mel_batch(config["num_mels"], T=16, seed=2))
    with torch.no_grad():
        ref = gen(mel)
        got = low(mel)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert all(p.dtype == torch.bfloat16 for p in low.parameters())
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    snr = 10 * math.log10((ref ** 2).mean().item() / max(((ref - got) ** 2).mean().item(), 1e-12))
    assert 30 < snr < 120, f"bf16 vocoder SNR {snr:.1f} dB"
