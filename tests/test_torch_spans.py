"""The port's profiler spans (`mixgantts_tpu_torch/utils/profiling.py::span`)
on the CPU, at tiny widths of the packaged LJSpeech configuration: a
shallow `TTSPipeline` call records each synthesis span inside its parent
(the kernel entries' plain versions included), a shallow chunked train
step records the training spans, a span without a profiler never reaches
`record_function`, and the outputs are bitwise the same with the profiler
on and off.
"""

import copy

import numpy as np
import pytest
import torch

from mixgantts_tpu_torch.cli.common import to_device
from mixgantts_tpu_torch.config import NormStats, get_configs_of
from mixgantts_tpu_torch.models.discriminator import JCUDiscriminator
from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator
from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
from mixgantts_tpu_torch.models.vocoder import Vocoder
from mixgantts_tpu_torch.pipeline import TTSPipeline
from mixgantts_tpu_torch.train import chunk_train_step, create_train_state, make_train_step
from mixgantts_tpu_torch.utils import profiling

TINY = {"transformer": {"encoder_layer": 1, "encoder_hidden": 32, "decoder_layer": 1,
                        "decoder_hidden": 32, "conv_filter_size": 64, "conv_kernel_size": 3},
        "denoiser": {"residual_layers": 2, "residual_channels": 16},
        "discriminator": {"n_channels": [8, 16, 32, 16, 1]},
        "variance_predictor": {"filter_size": 32},
        "variance_embedding": {"n_bins": 32},
        "max_seq_len": 128,
        "tpu": {"length_buckets": [64, 128], "phone_buckets": [8, 16, 32]}}
# stages of 128 channels (`mrf_stack`, whole) and 64 (`mrf_stack_folded`)
VOCODER = {"num_mels": 80, "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
           "upsample_initial_channel": 256, "resblock_kernel_sizes": [3, 5],
           "resblock_dilation_sizes": [[1, 3], [1, 3]]}

SYNTH_NESTING = {
    "model.encoder": "pipeline.submit", "model.decoder": "pipeline.submit",
    "model.postnet": "pipeline.submit", "model.diffusion": "pipeline.submit",
    "kernel.fused_residual_stack": "model.diffusion",
    "vocoder.upsample": "pipeline.submit", "vocoder.mrf": "pipeline.submit",
    "kernel.mrf_stack": "vocoder.mrf", "kernel.mrf_stack_folded": "vocoder.mrf",
    "pipeline.collect": None,
}
TRAIN_NESTING = {
    "data.to_device": None, "train.step": None,
    "train.d_phase": "train.step", "train.g_phase": "train.step",
    "train.forward": "train.step", "model.encoder": "train.forward",
    "model.diffusion": "train.forward",
    "train.losses": ("train.d_phase", "train.g_phase"),
    "train.backward": ("train.d_phase", "train.g_phase"),
    "train.update": ("train.d_phase", "train.g_phase"),
}


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def configs():
    pre, cfg, tc = get_configs_of("LJSpeech")
    return pre, _merge(cfg, TINY), tc


def generator(mode="shallow"):
    pre, cfg, _ = configs()
    torch.manual_seed(0)
    return MixGANTTS.from_configs(mode, pre, cfg, NormStats.default(), device="cpu")


def pipeline(mode="shallow"):
    pre, cfg, _ = configs()
    model = generator(mode).eval()
    torch.manual_seed(1)
    voc = HiFiGANGenerator.from_config(dict(VOCODER, sampling_rate=22050), device="cpu")
    return TTSPipeline(model, Vocoder("HiFi-GAN", voc.eval(), VOCODER), pre, cfg)


def synth_batch():
    r = np.random.default_rng(0)
    return {"speakers": np.zeros(2, np.int64), "texts": r.integers(1, 60, (2, 7)),
            "src_lens": np.array([7, 5]), "word_boundaries": np.array([[3, 2, 2], [3, 2, 0]]),
            "src_w_lens": np.array([3, 2])}


def train_batch(B=2, P=6, T=64):
    r = np.random.default_rng(1)
    prior = r.uniform(0.05, 1.0, (B, P, T)).astype(np.float32)
    return {"speakers": np.zeros(B, np.int64), "texts": r.integers(1, 60, (B, P)),
            "src_lens": np.array([P, P - 2]), "word_boundaries": np.array([[2, 2, 2], [2, 2, 0]]),
            "src_w_lens": np.array([3, 2]),
            "mels": r.uniform(-8.0, 1.0, (B, T, 80)).astype(np.float32),
            "mel_lens": np.array([T, T - 16]),
            "p_targets": r.standard_normal((B, P)).astype(np.float32),
            "e_targets": r.standard_normal((B, P)).astype(np.float32),
            "d_targets": np.array([[10, 10, 10, 10, 12, 12], [12, 12, 12, 12, 0, 0]]),
            "attn_priors": prior / prior.sum(1, keepdims=True)}


def trainer():
    """(state, chunk_fn) of a shallow GAN step past the aux phase."""
    pre, cfg, tc = configs()
    model = generator()
    disc = JCUDiscriminator.from_configs(pre, cfg, device="cpu")
    state = create_train_state(model, disc, tc, cfg,
                               restore_step=tc["step"]["total_step_aux"],
                               generator=torch.Generator().manual_seed(2))
    return state, chunk_train_step(make_train_step("shallow", model, disc, cfg, tc))


def synthesize(pipe):
    return pipe.collect(pipe.submit(synth_batch(), generator=torch.Generator().manual_seed(3)))


def train(state, chunk_fn, k=1):
    torch.manual_seed(4)
    stacked = {key: np.stack([v] * k) for key, v in train_batch().items()}
    return chunk_fn(state, to_device(stacked, torch.device("cpu")))


def profiled(fn, *args):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return out, spans


def check_nesting(spans, nesting):
    for name, parents in nesting.items():
        mine = [s for s in spans if s[0] == name]
        assert mine, f"no span {name}"
        if parents is None:
            continue
        parents = (parents,) if isinstance(parents, str) else parents
        outer = [s for s in spans if s[0] in parents]
        for _, lo, hi in mine:
            assert any(plo <= lo and hi <= phi for _, plo, phi in outer), (name, parents)


@pytest.fixture(scope="module")
def pipe():
    return pipeline()


def test_synthesis_spans_nest(pipe):
    _, spans = profiled(synthesize, pipe)
    check_nesting(spans, SYNTH_NESTING)
    names = [s[0] for s in spans]
    assert names.count("vocoder.upsample") == names.count("vocoder.mrf") == 2
    assert names.count("pipeline.submit") == names.count("pipeline.collect") == 1


def test_train_spans_nest():
    state, chunk_fn = trainer()
    _, spans = profiled(train, state, chunk_fn, 2)
    check_nesting(spans, TRAIN_NESTING)
    names = [s[0] for s in spans]
    assert names.count("train.step") == 2
    for name in ("train.d_phase", "train.g_phase"):
        assert names.count(name) == 2
    for name in ("train.forward", "train.losses", "train.backward", "train.update"):
        assert names.count(name) == 4, name   # twice a step: D's and G's


def test_span_without_a_profiler_records_nothing(pipe, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")
    synthesize(pipe)
    state, chunk_fn = trainer()
    train(state, chunk_fn)


def test_outputs_bitwise_equal_with_the_profiler_on_and_off(pipe):
    wavs, mel, lens = synthesize(pipe)
    (wavs_on, mel_on, lens_on), _ = profiled(synthesize, pipe)
    assert np.array_equal(lens, lens_on) and np.array_equal(mel, mel_on)
    assert all(np.array_equal(a, b) for a, b in zip(wavs, wavs_on))

    state, chunk_fn = trainer()
    state_on = copy.deepcopy(state)
    chunk_on = chunk_train_step(make_train_step("shallow", state_on.model,
                                                state_on.discriminator, configs()[1],
                                                configs()[2]))
    losses = train(state, chunk_fn)
    losses_on, _ = profiled(train, state_on, chunk_on)
    assert losses.keys() == losses_on.keys()
    for key in losses:
        assert torch.equal(losses[key], losses_on[key]), key
    for module, module_on in ((state.model, state_on.model),
                              (state.discriminator, state_on.discriminator)):
        for (name, p), (_, p_on) in zip(module.state_dict().items(),
                                        module_on.state_dict().items()):
            assert torch.equal(p, p_on), name
