"""The whole slice on the CPU, and the port's serving and packaging rules.

- The port's `TTSPipeline` (encoder -> decoder/PostNet -> diffusion with
  injected noise -> HiFi-GAN -> int16 on the device) against the JAX
  package's `model.apply(noise_override=...)` + `vocoder.apply_fn` + the
  same int16 clip, on the tiny configs of test_pipeline.py and
  test_vocoder.py: mel mean absolute error below 1e-3 (BASELINE.md), and
  int16 samples within 1 LSB (fp32 sums taken in another order can move a
  sample across a rounding boundary).
- `tpu.compute_dtype: bfloat16`: the port's pipeline on bf16 copies of
  the generator and vocoder against the JAX package's `model.apply` on
  `cast_floats(params, bf16)` with the same noise in bf16: equal lengths
  and mel mean |diff| < 5% of max|mel| (tests/test_pipeline.py's bar), and
  the bf16 vocoder against the fp32 one on that mel at SNR > 30 dB
  (tests/test_vocoder.py's bar).
- `submit`/`collect`/`stream`, the frame-budget warning, a malformed
  mesh, speaker embeddings reaching the model, and HiFi-GAN
  configs with per-branch dilations (the eager route, against flax at
  rtol 1e-4 / atol 1e-5).
- No module of the port imports JAX, flax or the JAX package (an AST scan),
  and the entry points (the model, the vocoders, the train and evaluate
  CLIs) refuse to run without a GPU unless asked for the CPU.
"""

import ast
import copy
import functools
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from mixgantts_tpu.models.vocoder import Vocoder as JVocoder
from mixgantts_tpu.pipeline import cast_floats
from mixgantts_tpu.utils.tools import bucket_length
from mixgantts_tpu_torch.cli import evaluate as evaluate_cli
from mixgantts_tpu_torch.cli import train as train_cli
from mixgantts_tpu_torch.config import NormStats, get_configs_of
from mixgantts_tpu_torch.models import hifigan as thifigan
from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
from mixgantts_tpu_torch.models.vocoder import Vocoder, get_vocoder
from mixgantts_tpu_torch.pipeline import TTSPipeline
from test_pipeline import MODEL_CONFIG, N_MELS, PREPROCESS_CONFIG
from test_vocoder import SMALL_CONFIG
from torch_port_helpers import (
    jax_generator, jax_multispeaker_generator, numpy_tree, speaker_batch, t,
    text_batch, torch_generator_like, torch_hifigan_like,
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


def jax_slice(mode, jvoc, batch, noise, dtype=jnp.float32):
    """What the JAX package's pipeline computes, with injected noise: the
    same buckets, the whole frame bucket vocoded, the same int16 clip; in
    bf16, its parameters and the noise cast as its pipeline casts them."""
    model, variables, apply = jax_generator(mode)
    if dtype != jnp.float32:
        variables = dict(variables, params=cast_floats(variables["params"], dtype))
        noise = cast_floats({k: jnp.asarray(v) for k, v in noise.items()}, dtype)
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


def slice_noise(mode, seed=5, B=2, T=128):
    model, _, _ = jax_generator(mode)
    r = np.random.RandomState(seed)
    return {"start_noise": r.randn(B, T, N_MELS).astype(np.float32),
            "step_noises": r.randn(model.schedule.num_timesteps, B, T,
                                   N_MELS).astype(np.float32)}


@pytest.mark.parametrize("mode", ["shallow", "naive"])
def test_bf16_pipeline_matches_jax(mode):
    batch = text_batch(B=2, P=10, W=4, seed=2)
    noise = slice_noise(mode)
    jvoc, tvoc = vocoders()
    _, want_mel, want_lens, _ = jax_slice(mode, jvoc, batch, noise, jnp.bfloat16)
    cfg16 = copy.deepcopy(MODEL_CONFIG)
    cfg16["tpu"]["compute_dtype"] = "bfloat16"
    pipe = port_pipeline(mode, mel_dtype=torch.float32)
    pipe16 = TTSPipeline(pipe.model, tvoc, PRE_CONFIG, cfg16, mel_dtype=torch.float32)
    wavs, mel, lens = pipe16(batch, noise_override=noise)
    np.testing.assert_array_equal(lens, want_lens)
    assert mel.dtype == np.float32 and np.isfinite(mel).all()
    assert np.abs(mel - want_mel).mean() / np.abs(want_mel).max() < 0.05
    for wav, n in zip(wavs, lens):
        assert wav.dtype == np.int16 and len(wav) == n * HOP
    # the vocoder: bf16 copy against the fp32 one on this mel
    with torch.no_grad():
        ref = tvoc(torch.as_tensor(mel))
        low = pipe16.vocoder(torch.as_tensor(mel))
    snr = 10 * np.log10((ref ** 2).mean().item() / max(((ref - low) ** 2).mean().item(), 1e-12))
    assert snr > 30, f"bf16 vocoder SNR {snr:.1f} dB"


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
    """A mesh that is neither a serving mesh nor a list of devices raises
    (sharded serving itself: tests/test_torch_parallel_serving.py), as does
    an unknown compute_dtype; bfloat16 serves bf16 copies (BatchNorm
    statistics and the diffusion tables stay fp32) and leaves the caller's
    modules in fp32; spker_embeds reach a model with an external speaker
    embedder."""
    model, variables, _ = jax_generator("shallow")
    port = torch_generator_like(model, variables)
    _, tvoc = vocoders()
    with pytest.raises(TypeError, match="mesh"):
        TTSPipeline(port, tvoc, PRE_CONFIG, MODEL_CONFIG, mesh=object())
    cfg = copy.deepcopy(MODEL_CONFIG)
    cfg["tpu"]["compute_dtype"] = "float16"
    with pytest.raises(ValueError, match="compute_dtype"):
        TTSPipeline(port, tvoc, PRE_CONFIG, cfg)
    cfg["tpu"]["compute_dtype"] = "bfloat16"
    pipe = TTSPipeline(port, tvoc, PRE_CONFIG, cfg)
    assert pipe.model is not port and pipe.vocoder.generator is not tvoc.generator
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(p.dtype == torch.float32 for p in tvoc.generator.parameters())
    assert all(p.dtype == torch.bfloat16 for p in pipe.vocoder.generator.parameters())
    assert pipe.model.postnet.convolutions[0][0].conv.weight.dtype == torch.bfloat16
    assert pipe.model.diffusion.denoise_fn.input_projection[0].conv.weight.dtype == torch.bfloat16
    # the encoder's parameters hold bf16 values in fp32
    w = pipe.model.linguistic_encoder.src_emb.weight
    assert w.dtype == torch.float32 and torch.equal(w, w.bfloat16().float())
    for name, buf in pipe.model.named_buffers():
        assert buf.dtype == dict(port.named_buffers())[name].dtype, name
    assert pipe.model.postnet.convolutions[0][1].running_var.dtype == torch.float32

    ms_model, ms_variables, _ = jax_multispeaker_generator("shallow", "DeepSpeaker")
    ms = TTSPipeline(torch_generator_like(ms_model, ms_variables), tvoc, PRE_CONFIG, MODEL_CONFIG,
                     mel_dtype=torch.float32)
    batch = speaker_batch(text_batch(), "DeepSpeaker")
    noise = slice_noise("shallow")
    _, mel, _ = ms(batch, noise_override=noise)
    _, moved, _ = ms(dict(batch, spker_embeds=batch["spker_embeds"][::-1].copy()),
                     noise_override=noise)
    assert np.abs(mel - moved).max() > 1e-3
    with pytest.raises(ValueError, match="spker_embeds"):
        ms({k: v for k, v in batch.items() if k != "spker_embeds"})


def test_hifigan_rejects_per_branch_dilations():
    """The kernels' route (`fused_apply`) rejects branches with different
    dilation schedules; the generator, built from such a config, takes the
    eager route and agrees with the flax HiFiGANGenerator."""
    cfg = dict(SMALL_CONFIG, resblock_dilation_sizes=[[1, 3], [1, 2]])
    gen = thifigan.HiFiGANGenerator.from_config(cfg, device="cpu")
    assert not gen.kernel_route
    with pytest.raises(NotImplementedError, match="dilation"):
        thifigan.fused_apply(gen, torch.zeros(1, 4, cfg["num_mels"]))
    module = JHiFiGAN.from_config(cfg)
    mel = np.random.RandomState(7).randn(2, 9, cfg["num_mels"]).astype(np.float32)
    params = jax.jit(module.init)(jax.random.PRNGKey(7), jnp.asarray(mel))["params"]
    want = jax.jit(module.apply)({"params": params}, jnp.asarray(mel))
    port = torch_hifigan_like(cfg, params)
    with torch.no_grad():
        got = port(t(mel))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def port_files():
    root = os.path.join(REPO, "mixgantts_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")
    # the test files and benches that run on the card, where there is no JAX
    for name in sorted(os.listdir(os.path.join(REPO, "tests"))):
        if name.startswith("bench_torch_") or name in (
                "test_torch_gpu_perf.py", "test_torch_gpu_kernels.py",
                "train_horizon_torch.py", "torch_horizon_helpers.py",
                "horizon_init_witness_torch.py", "horizon_batches_torch.py",
                "train_step_kinks_torch.py"):
            yield os.path.join(REPO, "tests", name)


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, nor the test files,
    benches and the long-horizon drive that run on the card, imports jax,
    flax or the JAX package (`mixgantts_tpu`; the port is
    `mixgantts_tpu_torch`), or a JAX-side test file the JAX drive takes
    its corpus and configs from."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "mixgantts_tpu",
              "test_data_pipeline", "test_cli", "test_multispeaker_e2e", "train_horizon"}
    files = list(port_files())
    assert len(files) > 10
    rel = {os.path.relpath(f, os.path.join(REPO, "mixgantts_tpu_torch")) for f in files}
    assert {"audio/stft.py", "audio/f0.py", "models/speaker_embedder.py",
            "data/preprocessor.py", "cli/preprocess.py", "cli/prepare_align.py",
            "parallel/__init__.py", "parallel/mesh.py", "parallel/tp.py",
            "parallel/collectives.py", "parallel/launch.py", "dryrun.py",
            "utils/profiling.py", "bench.py", "flagship.py"} <= rel
    assert {f"../tests/{name}.py" for name in (
        "bench_torch_serving", "bench_torch_step_parts", "bench_torch_denoiser_grad",
        "bench_torch_mrf", "bench_torch_denoiser", "test_torch_gpu_perf",
        "test_torch_gpu_kernels", "train_horizon_torch", "torch_horizon_helpers",
        "horizon_init_witness_torch", "horizon_batches_torch")} <= rel
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
    pre, cfg, tc = get_configs_of("LJSpeech")
    stats = NormStats.default()
    args = types.SimpleNamespace(model="aux", dataset="LJSpeech", restore_step=0, path_tag="",
                                 seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(args, (pre, cfg, tc))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_cli.cli(["--model", "aux", "--dataset", "LJSpeech"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MixGANTTS.from_configs("shallow", pre, cfg, stats)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_vocoder(cfg, ckpt_dir="/nonexistent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thifigan.HiFiGANGenerator.from_config(SMALL_CONFIG)
    small = get_vocoder(MODEL_CONFIG, ckpt_dir="/nonexistent",
                        num_mels=N_MELS, device="cpu")
    assert next(small.generator.parameters()).device.type == "cpu"
    ms = MixGANTTS.from_configs("shallow", pre, dict(cfg, multi_speaker=True), stats,
                                n_speakers=5, device="cpu")
    assert ms.speaker_emb.num_embeddings == 5
    assert next(ms.parameters()).device.type == "cpu"
