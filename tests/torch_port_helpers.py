"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: tiny models on both sides with the same weights (JAX init ->
`mixgantts_tpu_torch.convert` -> strict `load_state_dict`), and inputs made
with numpy."""

import dataclasses
import functools
import math

import jax
import numpy as np
import torch

from mixgantts_tpu_torch.config import NormStats as TorchNormStats
from mixgantts_tpu_torch.convert import generator_state_dict, hifigan_state_dict
from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator as TorchHiFiGAN
from mixgantts_tpu_torch.models.mixgantts import MixGANTTS as TorchMixGANTTS
from test_pipeline import text_batch, tiny_model  # noqa: F401  (re-exported)

# torch on one thread in every test process: the suite runs several
# processes at once (pytest-xdist), where torch's default of a thread per
# core oversubscribes the cores, and these models are small
torch.set_num_threads(1)

# frames per word the duration predictor's bias is set to, so that random
# weights give utterances of a realistic length
DURATION_FRAMES = 6.0
# the tiny multi-speaker models: speakers in the table, external embedding size
N_SPEAKERS, SPK_DIM = 3, 12


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def init_jax_generator(model, batch, T, seed=0):
    """Flax variables of a JAX MixGANTTS as numpy trees, with the duration
    predictor's output bias set to log(DURATION_FRAMES).  (Jitted: one
    compile is faster on the CPU than flax's op-by-op first calls.)"""
    init = jax.jit(model.init, static_argnames=("max_mel_len", "train"))
    variables = init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)},
        speakers=batch["speakers"], texts=batch["texts"],
        src_lens=batch["src_lens"], word_boundaries=batch["word_boundaries"],
        src_w_lens=batch["src_w_lens"], spker_embeds=batch.get("spker_embeds"),
        max_mel_len=T, train=False)
    variables = numpy_tree(variables)
    proj = variables["params"]["linguistic_encoder"]["duration_predictor"]["proj"]
    proj["bias"] = np.full_like(proj["bias"], math.log(DURATION_FRAMES))
    r = np.random.RandomState(seed)
    # the denoiser's output projection starts at zero, which would hide the
    # whole residual stack from every comparison
    out_proj = variables["params"]["denoiser"]["output_projection"]["conv"]
    out_proj["kernel"] = (r.randn(*out_proj["kernel"].shape) * 0.1).astype(np.float32)
    # random PostNet running statistics, so that eval-mode BatchNorm is tested
    for bn in variables.get("batch_stats", {}).get("postnet", {}).values():
        bn["mean"] = r.randn(*bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return variables


@functools.lru_cache(maxsize=None)
def jax_generator(mode):
    """(model, variables, jitted apply) of the tiny JAX MixGANTTS of a mode,
    made once per test process: the parameters do not depend on the input
    shapes, and the jitted apply compiles once per shape.  Callers must not
    modify the variables."""
    model = tiny_model(mode)
    variables = init_jax_generator(model, text_batch(), 32)
    apply = jax.jit(model.apply,
                    static_argnames=("max_mel_len", "train", "aux_only"))
    return model, variables, apply


def speaker_batch(batch, embedder, seed=0):
    """`batch` with speakers drawn from the table, and for an external
    embedder, spker_embeds [B, SPK_DIM]."""
    r = np.random.RandomState(seed)
    B = batch["texts"].shape[0]
    out = dict(batch, speakers=r.randint(0, N_SPEAKERS, B).astype(np.int64))
    if embedder != "none":
        out["spker_embeds"] = r.randn(B, SPK_DIM).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def jax_multispeaker_generator(mode, embedder):
    """`jax_generator` of a multi-speaker model: a table of N_SPEAKERS
    speakers (embedder "none") or a projection of SPK_DIM-wide external
    embeddings."""
    model = tiny_model(mode).clone(multi_speaker=True, n_speakers=N_SPEAKERS,
                                   embedder_type=embedder, external_speaker_dim=SPK_DIM)
    variables = init_jax_generator(model, speaker_batch(text_batch(), embedder), 32)
    apply = jax.jit(model.apply,
                    static_argnames=("max_mel_len", "train", "aux_only"))
    return model, variables, apply


def torch_generator_like(model, variables=None):
    """The port's MixGANTTS with the JAX model's hyper-parameters and the
    JAX weights (or, without `variables`, its own init), on the CPU."""
    stats = TorchNormStats(**dataclasses.asdict(model.stats))
    port = TorchMixGANTTS(
        mode=model.mode, betas=model.schedule.betas, stats=stats,
        hidden=model.hidden, encoder_layers=model.encoder_layers,
        encoder_heads=model.encoder_heads,
        conv_kernel_size=model.conv_kernel_size,
        encoder_window_size=model.encoder_window_size,
        decoder_layers=model.decoder_layers, decoder_heads=model.decoder_heads,
        conv_filter_size=model.conv_filter_size,
        max_seq_len=model.max_seq_len, n_mels=model.n_mels,
        n_bins=model.n_bins, pitch_quantization=model.pitch_quantization,
        energy_quantization=model.energy_quantization,
        vp_filter_size=model.vp_filter_size,
        vp_kernel_size=model.vp_kernel_size,
        residual_channels=model.residual_channels,
        residual_layers=model.residual_layers, multi_speaker=model.multi_speaker,
        n_speakers=model.n_speakers, embedder_type=model.embedder_type,
        external_speaker_dim=model.external_speaker_dim,
        encoder_dropout=model.encoder_dropout, decoder_dropout=model.decoder_dropout,
        vp_dropout=model.vp_dropout, device="cpu")
    if variables is not None:
        port.load_state_dict(generator_state_dict(
            variables["params"], variables.get("batch_stats", {})), strict=True)
    return port


def torch_hifigan_like(config, params):
    port = TorchHiFiGAN(
        n_mels=config["num_mels"], upsample_rates=config["upsample_rates"],
        upsample_kernel_sizes=config["upsample_kernel_sizes"],
        upsample_initial_channel=config["upsample_initial_channel"],
        resblock_kernel_sizes=config["resblock_kernel_sizes"],
        resblock_dilation_sizes=config["resblock_dilation_sizes"],
        device="cpu")
    port.load_state_dict(hifigan_state_dict(numpy_tree(params)), strict=True)
    return port


def t(a, dtype=None):
    """numpy -> CPU tensor (int64 for integer arrays)."""
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.long if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a, dtype=dtype)


def assert_close(got, want, rtol, atol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)
