"""The port's benchmark (`mixgantts_tpu_torch.bench`) and its flagship
helpers (`mixgantts_tpu_torch.flagship`) against the JAX side's, on the CPU:

- `example_text_batch` equals `__graft_entry__._example_text_batch` value
  for value (the port's integers int64);
- `flagship_model(tiny=True)`'s configs equal `_flagship_model(tiny=True)`'s,
  and the JAX model's weights load into it strictly through the bridge;
- the bench's timed function (`bench.synthesize`: the model over the whole
  frame budget, the vocoder on the whole mel) at tiny width, with bridged
  weights and injected noise, against the root bench.py's `model.apply` +
  `vocoder.apply_fn` on a small HiFi-GAN of 80 mels: mel mean absolute
  error below 1e-3 (BASELINE.md) and int16 within 1 LSB after the same
  clip (test_torch_pipeline.py's bars);
- `python -m mixgantts_tpu_torch.bench --cpu-selftest` exits 0 and prints
  the root bench.py's four keys under the self-test's metric; without a
  CUDA device and without the flag the bench prints a null value with an
  error and exits 1;
- the manual GPU benches (`tests/bench_torch_{serving,step_parts,
  denoiser_grad}.py`) run on the CPU at a tiny size and print their lines.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_text_batch, _flagship_model
from mixgantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from mixgantts_tpu.models.vocoder import Vocoder as JVocoder
from mixgantts_tpu_torch import bench
from mixgantts_tpu_torch.convert import generator_state_dict
from mixgantts_tpu_torch.flagship import TINY_REQUEST, example_text_batch, flagship_model
from mixgantts_tpu_torch.models.vocoder import Vocoder
from test_vocoder import SMALL_CONFIG
from torch_port_helpers import init_jax_generator, numpy_tree, torch_hifigan_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}   # the root bench.py's line


@pytest.mark.parametrize("B,P,W,rng", [(1, 64, 24, 0), (8, 128, 48, 0), (1, 32, 12, 0),
                                       (4, 64, 20, 3), (1, 16, 5, 0)])
def test_example_text_batch_equals_the_jax_helper(B, P, W, rng):
    got = example_text_batch(B=B, P=P, W=W, rng=rng)
    want = _example_text_batch(B=B, P=P, W=W, rng=rng)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == np.int64 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_tiny_flagship_configs_equal_the_jax_helper():
    _, want = _flagship_model("shallow", tiny=True)
    model, got = flagship_model("shallow", tiny=True, device="cpu")
    assert got == want
    assert model.max_seq_len == 16 and model.diffusion.denoise_fn.residual_channels == 8
    P, W = TINY_REQUEST   # 1-3 phones a word: the request fits the tiny model's positions
    assert 3 * W <= P <= model.max_seq_len


def test_timed_function_matches_the_jax_bench():
    jmodel, (_, mc, _) = _flagship_model("shallow", tiny=True)
    T = mc["max_seq_len"]
    P, W = TINY_REQUEST
    jbatch = _example_text_batch(B=1, P=P, W=W, rng=0)
    variables = init_jax_generator(jmodel, jbatch, T)
    model, _ = flagship_model("shallow", tiny=True, device="cpu")
    model.load_state_dict(generator_state_dict(variables["params"],
                                               variables.get("batch_stats", {})), strict=True)
    config = dict(SMALL_CONFIG, num_mels=jmodel.n_mels)
    module = JHiFiGAN.from_config(config)
    vparams = numpy_tree(jax.jit(module.init)(jax.random.PRNGKey(3),
                                              jnp.zeros((1, 4, jmodel.n_mels)))["params"])
    jvoc = JVocoder("HiFi-GAN", module, vparams, config=config)
    tvoc = Vocoder("HiFi-GAN", torch_hifigan_like(config, vparams), config)
    r = np.random.RandomState(5)
    noise = {"start_noise": r.randn(1, T, jmodel.n_mels).astype(np.float32),
             "step_noises": r.randn(jmodel.schedule.num_timesteps, 1, T,
                                    jmodel.n_mels).astype(np.float32)}

    # the root bench.py's jitted `synthesize`, with the noise injected
    out = jmodel.apply(variables, **jbatch, max_mel_len=T, train=False, noise_override=noise,
                       rngs={"diffusion": jax.random.PRNGKey(3)})
    want_wav = np.asarray(jax.jit(jvoc.apply_fn)(jvoc.params, out.mel_pred))
    wav, mel, lens = bench.synthesize(
        model, tvoc, {k: torch.as_tensor(v) for k, v in example_text_batch(1, P, W).items()}, T,
        noise_override={k: torch.as_tensor(v) for k, v in noise.items()})
    np.testing.assert_array_equal(lens.numpy(), np.asarray(out.mel_lens))
    assert mel.shape == (1, T, jmodel.n_mels) and wav.shape == want_wav.shape
    assert np.abs(mel.numpy() - np.asarray(out.mel_pred)).mean() < 1e-3

    def int16(w):
        return np.clip(w * 32768.0, -32768.0, 32767.0).astype(np.int16).astype(np.int32)

    assert np.abs(int16(wav.numpy()) - int16(want_wav)).max() <= 1
    assert np.abs(int16(want_wav)).max() > 0


def run(args, timeout=240):
    """A command of this repo in a subprocess on one CPU thread: (rc, stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable] + args, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def test_cpu_selftest_prints_the_bench_line():
    rc, stdout, stderr = run(["-m", "mixgantts_tpu_torch.bench", "--cpu-selftest"])
    assert rc == 0, stderr[-2000:]
    line = json.loads(stdout.strip().splitlines()[-1])
    assert set(line) == BENCH_KEYS and line["metric"] == bench.SELFTEST_METRIC
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(
        bench.TARGET_RTF / line["value"])
    assert "launches per request" in stderr


def test_no_gpu_prints_a_null_value_and_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == bench.METRIC and line["value"] is None
    assert "CUDA" in line["error"] and "vs_baseline" not in line


@pytest.mark.parametrize("args,lines", [
    (["tests/bench_torch_serving.py", "2", "stream", "--device", "cpu", "--tiny",
      "--iters", "2"], ["variant=stream", "pipeline stream:", "utt/s"]),
    (["tests/bench_torch_serving.py", "1", "nomel", "--device", "cpu", "--tiny",
      "--iters", "1"], ["return_mel=False", "pipeline nomel:", "ms/utt"]),
    (["tests/bench_torch_step_parts.py", "2", "16", "--device", "cpu", "--tiny",
      "--iters", "1"], ["generator fwd ", "generator fwd+bwd", "discriminator fwd ",
                        "discriminator fwd+bwd", "GFLOP"]),
    (["tests/bench_torch_denoiser_grad.py", "1", "8", "--device", "cpu", "--iters", "1"],
     ["20 x 256 unfused", "denoiser fwd ", "denoiser fwd+bwd"]),
], ids=["serving_stream", "serving_nomel", "step_parts", "denoiser_grad"])
def test_gpu_benches_run_on_the_cpu(args, lines):
    rc, stdout, stderr = run(args)
    assert rc == 0, stderr[-2000:]
    assert "device cpu: plumbing only" in stdout
    for text in lines:
        assert text in stdout, (text, stdout)
