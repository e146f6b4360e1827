"""The whole slice on the CPU, and the port's serving and packaging rules.

- The port's `TTSPipeline` (encoder -> decoder/PostNet -> diffusion with
  injected noise -> HiFi-GAN -> int16 on the device) against the JAX
  package's `model.apply(noise_override=...)` + `vocoder.apply_fn` + the
  same int16 clip, on the tiny configs of test_pipeline.py and
  test_vocoder.py: mel mean absolute error below 1e-3 (BASELINE.md), and
  int16 samples within 1 LSB (fp32 sums taken in another order can move a
  sample across a rounding boundary).
- `submit`/`collect`/`stream`, the frame-budget warning and the options
  not ported yet.
- No module of the port imports JAX, flax or the JAX package (an AST scan),
  and the entry points refuse to run without a GPU unless asked for the CPU.
"""

import ast
import copy
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from mixgantts_tpu.models.vocoder import Vocoder as JVocoder
from mixgantts_tpu.utils.tools import bucket_length
from mixgantts_tpu_torch.config import NormStats, get_configs_of
from mixgantts_tpu_torch.models import hifigan as thifigan
from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
from mixgantts_tpu_torch.models.vocoder import Vocoder, get_vocoder
from mixgantts_tpu_torch.pipeline import TTSPipeline
from test_pipeline import MODEL_CONFIG, N_MELS, PREPROCESS_CONFIG
from test_vocoder import SMALL_CONFIG
from torch_port_helpers import (
    jax_generator, numpy_tree, text_batch, torch_generator_like,
    torch_hifigan_like,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCODER_CONFIG = dict(SMALL_CONFIG, num_mels=N_MELS)
HOP = int(np.prod(VOCODER_CONFIG["upsample_rates"]))   # samples per frame
PRE_CONFIG = copy.deepcopy(PREPROCESS_CONFIG)
PRE_CONFIG["preprocessing"]["stft"]["hop_length"] = HOP


@functools.lru_cache(maxsize=None)
def vocoders():
    """The JAX tiny HiFi-GAN and the port's copy of it, made once."""
    module = JHiFiGAN.from_config(VOCODER_CONFIG)
    params = numpy_tree(jax.jit(module.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, N_MELS)))["params"])
    jvoc = JVocoder("HiFi-GAN", module, params, config=VOCODER_CONFIG)
    tvoc = Vocoder("HiFi-GAN", torch_hifigan_like(VOCODER_CONFIG, params),
                   VOCODER_CONFIG)
    return jvoc, tvoc


def port_pipeline(mode, **kwargs):
    model, variables, _ = jax_generator(mode)
    _, tvoc = vocoders()
    return TTSPipeline(torch_generator_like(model, variables), tvoc,
                       PRE_CONFIG, MODEL_CONFIG, **kwargs)


def jax_slice(mode, jvoc, batch, noise):
    """What the JAX package's pipeline computes, with injected noise: the
    same buckets, the whole frame bucket vocoded, the same int16 clip."""
    model, variables, apply = jax_generator(mode)
    buckets = MODEL_CONFIG["tpu"]
    P = bucket_length(batch["texts"].shape[1], buckets["phone_buckets"])
    W = bucket_length(batch["word_boundaries"].shape[1], buckets["phone_buckets"])
    T = bucket_length(min(MODEL_CONFIG["max_seq_len"],
                          max(64, batch["texts"].shape[1] * 16)),
                      buckets["length_buckets"])
    out = apply(
        variables, speakers=batch["speakers"],
        texts=np.pad(batch["texts"], ((0, 0), (0, P - batch["texts"].shape[1]))),
        src_lens=batch["src_lens"],
        word_boundaries=np.pad(batch["word_boundaries"],
                               ((0, 0), (0, W - batch["word_boundaries"].shape[1]))),
        src_w_lens=batch["src_w_lens"], max_mel_len=T, train=False,
        noise_override=noise, rngs={"diffusion": jax.random.PRNGKey(0)})
    mel = out.mel_pred
    if mode == "aux":
        mel = model.schedule.denorm_spec(mel[0])
    wav = jax.jit(jvoc.apply_fn)(jvoc.params, mel)
    max_wav = PRE_CONFIG["preprocessing"]["audio"]["max_wav_value"]
    wav = np.asarray(jnp.clip(wav * max_wav, -max_wav, max_wav - 1).astype(jnp.int16))
    lens = np.asarray(out.mel_lens)
    return [wav[i, :lens[i] * HOP] for i in range(len(lens))], np.asarray(mel), lens, T


@pytest.mark.parametrize("mode", ["shallow", "naive", "aux"])
def test_slice_matches_jax(mode):
    model, _, _ = jax_generator(mode)
    batch = text_batch(B=2, P=10, W=4, seed=2)
    T = 128    # the frame bucket of P = 10
    r = np.random.RandomState(5)
    noise = {"start_noise": r.randn(2, T, N_MELS).astype(np.float32),
             "step_noises": r.randn(model.schedule.num_timesteps, 2, T,
                                    N_MELS).astype(np.float32)}
    jvoc, _ = vocoders()
    want_wavs, want_mel, want_lens, want_T = jax_slice(mode, jvoc, batch, noise)
    assert want_T == T
    pipe = port_pipeline(mode, mel_dtype=torch.float32)
    wavs, mel, lens = pipe(batch, noise_override=noise)
    np.testing.assert_array_equal(lens, want_lens)
    assert lens.min() > 0
    assert mel.shape == want_mel.shape and np.isfinite(mel).all()
    assert np.abs(mel - want_mel).mean() < 1e-3
    for got, want in zip(wavs, want_wavs):
        assert got.dtype == np.int16 and got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_submit_collect_and_stream():
    """stream() keeps batches in flight and yields what one call per batch
    gives, in order; explicit generators set the draws; return_mel=False
    drops the mel only; a short `generators` list is a clear error."""
    pipe = port_pipeline("shallow")
    batches = [text_batch(seed=s) for s in range(3)]
    gens = lambda: [torch.Generator().manual_seed(s) for s in range(3)]
    sequential = [pipe.collect(pipe.submit(b, generator=g))
                  for b, g in zip(batches, gens())]
    streamed = list(pipe.stream(batches, generators=gens()))
    assert len(streamed) == 3
    for (w1, m1, l1), (w2, m2, l2) in zip(sequential, streamed):
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(m1, m2)
        for a, b in zip(w1, w2):
            assert a.dtype == np.int16 and len(a) == len(b)
            np.testing.assert_array_equal(a, b)
    wavs, mel, lens = pipe(batches[0], generator=gens()[0], return_mel=False)
    assert mel is None
    for a, b in zip(wavs, sequential[0][0]):
        np.testing.assert_array_equal(a, b)
    for i, wav in enumerate(wavs):
        assert len(wav) == int(lens[i]) * HOP
    with pytest.raises(ValueError, match="generators.*ran out"):
        list(pipe.stream(batches, generators=gens()[:1]))


def test_pipeline_warns_when_frame_budget_saturates():
    pipe = port_pipeline("shallow")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, mel, lens = pipe(text_batch(), d_control=1000.0)
    assert (lens >= mel.shape[1]).any()
    assert any("frame budget saturated" in str(w.message) for w in caught)


def test_pipeline_options_not_ported_raise():
    model, variables, _ = jax_generator("shallow")
    port = torch_generator_like(model, variables)
    _, tvoc = vocoders()
    with pytest.raises(NotImplementedError, match="mesh"):
        TTSPipeline(port, tvoc, PRE_CONFIG, MODEL_CONFIG, mesh=object())
    cfg16 = copy.deepcopy(MODEL_CONFIG)
    cfg16["tpu"]["compute_dtype"] = "bfloat16"
    with pytest.raises(NotImplementedError, match="bfloat16"):
        TTSPipeline(port, tvoc, PRE_CONFIG, cfg16)
    batch = dict(text_batch(), spker_embeds=np.zeros((2, 512), np.float32))
    with pytest.raises(NotImplementedError, match="speaker"):
        TTSPipeline(port, tvoc, PRE_CONFIG, MODEL_CONFIG).submit(batch)


def test_hifigan_rejects_per_branch_dilations():
    cfg = dict(SMALL_CONFIG, resblock_dilation_sizes=[[1, 3], [1, 2]])
    gen = thifigan.HiFiGANGenerator.from_config(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="dilation"):
        gen(torch.zeros(1, 4, cfg["num_mels"]))


def port_files():
    root = os.path.join(REPO, "mixgantts_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax or the
    JAX package (`mixgantts_tpu`; the port is `mixgantts_tpu_torch`)."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "mixgantts_tpu"}
    files = list(port_files())
    assert len(files) > 10
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__")):
                names = [node.args[0].value]
            else:
                continue
            offenders += [f"{path}:{node.lineno} {n}" for n in names
                          if str(n).split(".")[0] in banned]
    assert not offenders, offenders


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pre, cfg, _ = get_configs_of("LJSpeech")
    stats = NormStats.default()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MixGANTTS.from_configs("shallow", pre, cfg, stats)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_vocoder(cfg, ckpt_dir="/nonexistent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thifigan.HiFiGANGenerator.from_config(SMALL_CONFIG)
    small = get_vocoder(MODEL_CONFIG, ckpt_dir="/nonexistent",
                        num_mels=N_MELS, device="cpu")
    assert next(small.generator.parameters()).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="multi-speaker"):
        MixGANTTS.from_configs("shallow", pre, dict(cfg, multi_speaker=True),
                               stats, device="cpu")
