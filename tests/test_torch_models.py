"""The port's modules against the JAX package's flax modules on the CPU,
with the weights carried across by the bridge
(`mixgantts_tpu_torch.convert`) and loaded with `strict=True`.

Inputs and diffusion noise are made with numpy and given to both sides.
Tolerances: blocks, encoder, decoder and denoiser agree to 1e-4 (fp32,
sums taken in another order by XLA and PyTorch); integer outputs
(durations, lengths) are equal; the generator's mel agrees to a mean
absolute error below 1e-3 (BASELINE.md's parity target); HiFi-GAN agrees
to rtol 1e-4 / atol 1e-5, as test_vocoder.py holds the Pallas path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu import convert as jconvert
from mixgantts_tpu.models.blocks import RelativeFFTBlock as JRelativeFFTBlock
from mixgantts_tpu.models.denoiser import Denoiser as JDenoiser
from mixgantts_tpu.models.hifigan import (
    HiFiGANGenerator as JHiFiGAN, convert_torch_generator,
)
from mixgantts_tpu.models.vocoder import (
    DEFAULT_HIFIGAN_CONFIG, get_vocoder as j_get_vocoder,
)
from mixgantts_tpu_torch import convert as tconvert
from mixgantts_tpu_torch.models.blocks import RelativeFFTBlock
from mixgantts_tpu_torch.models.denoiser import Denoiser
from mixgantts_tpu_torch.models.vocoder import get_vocoder
from test_vocoder import SMALL_CONFIG, build_torch_hifigan
from torch_port_helpers import (
    assert_close, jax_generator, numpy_tree, t, text_batch,
    torch_generator_like, torch_hifigan_like,
)


def strip(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("L", [3, 7])   # shorter and longer than window + 1
def test_relative_fft_block_matches_flax(L):
    """Relative attention (skews, window padding or slicing), LayerNorm
    eps 1e-4 and the masked FFN, with one fully masked row: NEG_INF gives a
    uniform row that the mask zeroes, never NaN."""
    H, B = 16, 3
    r = np.random.RandomState(L)
    x = r.randn(B, L, H).astype(np.float32)
    lengths = np.array([L, 2, 0])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)[..., None]
    block = JRelativeFFTBlock(H, n_heads=2, n_layers=2, kernel_size=3, window_size=4)
    params = numpy_tree(jax.jit(block.init)(jax.random.PRNGKey(L), x, mask)["params"])
    want = jax.jit(block.apply)({"params": params}, x, mask)
    sd = {}
    tconvert._relative_fft(params, "b", sd)
    port = RelativeFFTBlock(H, 2, 2, 3, 4)
    port.load_state_dict(strip(sd, "b."), strict=True)
    with torch.no_grad():
        got = port(t(x), t(mask))
    assert torch.isfinite(got).all()
    assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C,L", [(16, 3), (544, 2)])
def test_denoiser_matches_flax(C, L):
    """The denoiser module, whose residual stack is kernel 1 (its plain
    version on CPU tensors), against the flax layer-by-layer path; 544 is
    a width the CUDA kernel runs on its wide route."""
    B, T, M, Hc = 2, 23, 20, 24
    r = np.random.RandomState(0)
    x_t = r.randn(B, T, M).astype(np.float32)
    steps = np.array([0, 3])
    cond = r.randn(B, T, Hc).astype(np.float32)
    jden = JDenoiser(n_mels=M, d_encoder=Hc, residual_channels=C,
                     residual_layers=L, fused=False)
    params = numpy_tree(jax.jit(jden.init)(jax.random.PRNGKey(0), x_t, steps, cond)["params"])
    out = params["output_projection"]["conv"]
    out["kernel"] = (r.randn(*out["kernel"].shape) * 0.1).astype(np.float32)
    want = jax.jit(jden.apply)({"params": params}, x_t, steps, cond)
    sd = {}
    tconvert._denoiser(params, sd)
    port = Denoiser(n_mels=M, d_encoder=Hc, residual_channels=C, residual_layers=L)
    port.load_state_dict(strip(sd, "diffusion.denoise_fn."), strict=True)
    with torch.no_grad():
        got = port(t(x_t), t(steps), t(cond))
    assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_encoder_and_decoder_match_flax():
    """Linguistic encoder (bucketize bins, duration rounding, length
    regulation, word-to-phoneme attention), FFT decoder, mel_linear and
    PostNet (eval BatchNorm on the running statistics)."""
    model, variables, apply = jax_generator("shallow")
    batch = text_batch(B=3, P=12, W=5, seed=4)
    batch["src_w_lens"] = np.array([5, 3, 5])
    batch["word_boundaries"][1, 3:] = 0
    batch["src_lens"] = batch["word_boundaries"].sum(-1)
    batch["texts"][1, batch["src_lens"][1]:] = 0
    T = 96
    want = apply(
        variables, speakers=batch["speakers"], texts=batch["texts"],
        src_lens=batch["src_lens"], word_boundaries=batch["word_boundaries"],
        src_w_lens=batch["src_w_lens"], max_mel_len=T, train=False,
        aux_only=True)
    port = torch_generator_like(model, variables)
    with torch.no_grad():
        enc = port.linguistic_encoder(
            t(batch["texts"]), t(batch["src_lens"]), t(batch["word_boundaries"]),
            t(batch["src_w_lens"]), T)
        coarse = port.mel_linear(port.decoder(enc.features, enc.mel_mask))
        coarse = coarse + port.postnet(coarse)
    np.testing.assert_array_equal(enc.dur_w_rounded.numpy(), np.asarray(want.dur_w_rounded))
    np.testing.assert_array_equal(enc.mel_len.numpy(), np.asarray(want.mel_lens))
    np.testing.assert_array_equal(enc.mel_mask.numpy(), np.asarray(want.mel_mask))
    assert_close(enc.pitch_pred, want.pitch_pred, rtol=1e-4, atol=1e-4)
    assert_close(enc.energy_pred, want.energy_pred, rtol=1e-4, atol=1e-4)
    assert_close(enc.log_dur_w_pred, want.log_dur_w_pred, rtol=1e-4, atol=1e-4)
    assert_close(enc.features, want.features, rtol=1e-4, atol=1e-4)
    assert_close(coarse, want.coarse_mel, rtol=1e-4, atol=1e-4)


def noise_for(model, B, T, seed=0):
    r = np.random.RandomState(seed)
    S = model.schedule.num_timesteps
    return {"start_noise": r.randn(B, T, model.n_mels).astype(np.float32),
            "step_noises": r.randn(S, B, T, model.n_mels).astype(np.float32)}


@pytest.mark.parametrize("mode", ["shallow", "naive", "aux"])
def test_generator_matches_flax(mode):
    """The whole generator in each inference mode with injected noise; aux
    compares element 0 of its trace, the only deterministic one."""
    model, variables, apply = jax_generator(mode)
    batch = text_batch(B=2, P=10, W=4, seed=1)
    T = 128
    ov = noise_for(model, 2, T)
    want = apply(
        variables, speakers=batch["speakers"], texts=batch["texts"],
        src_lens=batch["src_lens"], word_boundaries=batch["word_boundaries"],
        src_w_lens=batch["src_w_lens"], max_mel_len=T, train=False,
        noise_override=ov, rngs={"diffusion": jax.random.PRNGKey(0)})
    port = torch_generator_like(model, variables)
    with torch.no_grad():
        got = port(t(batch["speakers"]), t(batch["texts"]), t(batch["src_lens"]),
                   t(batch["word_boundaries"]), t(batch["src_w_lens"]), T,
                   noise_override={k: t(v) for k, v in ov.items()})
    np.testing.assert_array_equal(got.mel_lens.numpy(), np.asarray(want.mel_lens))
    assert int(got.mel_lens.min()) > 0
    a, b = got.mel_pred.numpy(), np.asarray(want.mel_pred)
    if mode == "aux":
        a, b = a[0], b[0]
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    assert np.abs(a - b).mean() < 1e-3
    assert_close(a, b, rtol=1e-3, atol=1e-3)


def test_generator_bridge_round_trip():
    """JAX trees -> the port's state_dict -> `mixgantts_tpu.convert`'s
    reader gives back the same trees, bit for bit, in every mode."""
    for mode in ("shallow", "naive"):
        model, variables, _ = jax_generator(mode)
        sd = tconvert.generator_state_dict(variables["params"],
                                           variables.get("batch_stats", {}))
        params, stats = jconvert.convert_generator(
            {k: v.numpy() for k, v in sd.items()}, mode,
            encoder_layers=model.encoder_layers,
            decoder_layers=model.decoder_layers,
            denoiser_layers=model.residual_layers)
        want = (variables["params"], variables.get("batch_stats", {}))
        for got_tree, want_tree in zip((params, stats), want):
            assert (jax.tree_util.tree_structure(got_tree)
                    == jax.tree_util.tree_structure(want_tree))
            for g, w in zip(jax.tree_util.tree_leaves(got_tree),
                            jax.tree_util.tree_leaves(want_tree)):
                np.testing.assert_array_equal(g, w)


def test_hifigan_bridge_round_trip():
    module = JHiFiGAN.from_config(SMALL_CONFIG)
    params = numpy_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)))["params"])
    sd = tconvert.hifigan_state_dict(params)
    back = numpy_tree(convert_torch_generator(
        {k: v.numpy() for k, v in sd.items()}, SMALL_CONFIG))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("config,T_mel", [
    (SMALL_CONFIG, 13),   # C = 8, 4: every stage whole (frames not fold-divisible)
    (SMALL_CONFIG, 16),   # C = 8, 4: every stage time-folded (F = 16, 32)
    # V1's first two stages: C = 256 one call per branch, C = 128 whole
    (dict(DEFAULT_HIFIGAN_CONFIG, num_mels=20, upsample_rates=[2, 2],
          upsample_kernel_sizes=[4, 4]), 5),
])
def test_hifigan_matches_flax(config, T_mel):
    """The port's `fused_apply` (kernels 2 and 3, plain versions on the CPU)
    against the flax HiFi-GAN graph."""
    module = JHiFiGAN.from_config(config)
    mel = np.random.RandomState(T_mel).randn(2, T_mel, config["num_mels"]).astype(np.float32)
    params = jax.jit(module.init)(jax.random.PRNGKey(T_mel), jnp.asarray(mel))["params"]
    want = jax.jit(module.apply)({"params": params}, jnp.asarray(mel))
    port = torch_hifigan_like(config, params)
    with torch.no_grad():
        got = port(t(mel))
    assert got.shape == want.shape
    assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_get_vocoder_loads_weight_normed_checkpoint(tmp_path):
    """`get_vocoder` loads `generator_{speaker}.pth.tar` natively (weight
    norm folded) and agrees with the JAX package loading the same file and
    with the torch generator that wrote it."""
    oracle = build_torch_hifigan(SMALL_CONFIG).eval()
    torch.save({"generator": oracle.state_dict()},
               tmp_path / "generator_LJSpeech.pth.tar")
    (tmp_path / "config.json").write_text(json.dumps(SMALL_CONFIG))
    model_config = {"vocoder": {"model": "HiFi-GAN", "speaker": "LJSpeech"}}
    mel = np.random.RandomState(0).randn(2, 11, SMALL_CONFIG["num_mels"]).astype(np.float32)
    with torch.no_grad():
        want = oracle(t(mel).transpose(1, 2))[:, 0]
        got = get_vocoder(model_config, ckpt_dir=str(tmp_path), device="cpu")(t(mel))
    jvoc = j_get_vocoder(model_config, ckpt_dir=str(tmp_path))
    assert_close(got, jvoc.apply_fn(jvoc.params, jnp.asarray(mel)), rtol=1e-4, atol=1e-5)
    assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_get_vocoder_random_init_honours_num_mels():
    model_config = {"vocoder": {"model": "HiFi-GAN", "speaker": "LJSpeech"}}
    a = get_vocoder(model_config, ckpt_dir="/nonexistent", num_mels=20, device="cpu")
    b = get_vocoder(model_config, ckpt_dir="/nonexistent", num_mels=20, device="cpu")
    assert a.generator.conv_pre.in_channels == 20
    # seeded: two builds give the same weights (torch.equal: exact, and no
    # lazy imports that other files' stub modules can break)
    assert torch.equal(a.generator.conv_post.weight, b.generator.conv_post.weight)
    melgan = get_vocoder({"vocoder": {"model": "MelGAN", "speaker": "x"}},
                         ckpt_dir="/nonexistent", num_mels=20, device="cpu")
    assert melgan.name == "MelGAN" and melgan.generator.model[1].in_channels == 20
    with pytest.raises(ValueError, match="unknown vocoder"):
        get_vocoder({"vocoder": {"model": "WaveNet", "speaker": "x"}}, device="cpu")
