"""Sharded serving (`TTSPipeline(mesh=...)`, `mixgantts_tpu_torch.pipeline`)
on the CPU: one replica of the generator and vocoder per mesh entry, a
mesh of `["cpu"] * 8` (an entry may repeat a device), the tiny models of
`tests/test_torch_pipeline.py`.

- Against the single pipeline with the same generator seed (the mesh
  draws the noise once for the padded batch, in the model's order and
  types, and splits it), naive and shallow, fp32 and bf16, and a
  multi-speaker model with external embeddings: equal lengths, the mel
  within rtol 1e-5 / atol 1e-5, the int16 samples within 1 (each replica
  computes its rows at another batch size, which may move an fp32 sum by
  an ulp).  In bf16 such a move may flip an intermediate's rounding: the
  mel within one bf16 step of its largest value (1/128 of it) and on
  average within 1e-4 of it, the samples at SNR > 30 dB
  (`tests/test_vocoder.py`'s bf16 bar).  A ragged B=3 pads to the mesh and comes back as 3 utterances
  equal to the first 3 of the full batch.
- Against the JAX package's mesh pipeline on the virtual 8-device CPU
  platform (aux mode, whose output draws no noise), at
  `tests/test_parallel_serving.py`'s bars: equal lengths, the mel at rtol
  1e-4 / atol 2e-2, the int16 samples within 2.
- A tensor-parallel or multi-process mesh is refused: serving is
  single-process data parallelism, as JAX's serving mesh has only `data`.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from mixgantts_tpu.parallel import make_mesh as j_make_mesh
from mixgantts_tpu.pipeline import TTSPipeline as JTTSPipeline
from mixgantts_tpu_torch.ops.denoiser_stack import fused_residual_stack
from mixgantts_tpu_torch.parallel import make_mesh
from mixgantts_tpu_torch.pipeline import TTSPipeline
from test_pipeline import MODEL_CONFIG, N_MELS
from test_torch_pipeline import HOP, PRE_CONFIG, vocoders
from torch_port_helpers import (
    jax_generator, jax_multispeaker_generator, speaker_batch, text_batch, torch_generator_like,
)


def pipelines(model, variables, config=MODEL_CONFIG, n=8):
    _, tvoc = vocoders()
    port = torch_generator_like(model, variables)
    single = TTSPipeline(port, tvoc, PRE_CONFIG, config, mel_dtype=torch.float32)
    sharded = TTSPipeline(port, tvoc, PRE_CONFIG, config, mesh=make_mesh(["cpu"] * n),
                          mel_dtype=torch.float32)
    return single, sharded


def check_equal(got, want, dtype="float32"):
    """The bars of the module docstring (fp32, or bf16)."""
    (wg, mg, lg), (ww, mw, lw) = got, want
    np.testing.assert_array_equal(lg, lw)
    if dtype == "float32":
        np.testing.assert_allclose(mg, mw, rtol=1e-5, atol=1e-5)
    else:
        top = np.abs(mw).max()
        assert np.abs(mg - mw).max() <= top / 128 and np.abs(mg - mw).mean() < 1e-4 * top
    assert len(wg) == len(ww)
    for a, b, n in zip(wg, ww, lg):
        assert a.dtype == np.int16 and len(a) == int(n) * HOP
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        if dtype == "float32":
            assert diff.max(initial=0) <= 1
        else:
            snr = 10 * np.log10((b.astype(np.float64) ** 2).mean()
                                / max((diff.astype(np.float64) ** 2).mean(), 1e-12))
            assert snr > 30, f"bf16 replica against one pipeline: SNR {snr:.1f} dB"


def rows(batch, n):
    return {k: v[:n] for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["naive", "shallow"])
def test_mesh_pipeline_matches_single_and_pads_ragged_batches(mode, dtype):
    model, variables, _ = jax_generator(mode)
    config = copy.deepcopy(MODEL_CONFIG)
    config["tpu"]["compute_dtype"] = dtype
    single, sharded = pipelines(model, variables, config)
    assert len(sharded.replicas) == 8
    assert all(m is not sharded.model for m, _ in sharded.replicas)
    batch = text_batch(B=8, P=16, seed=4)
    gen = lambda: torch.Generator().manual_seed(11)
    want = single(batch, generator=gen())
    check_equal(sharded(batch, generator=gen()), want, dtype)
    # ragged: B=3 pads to 8 with row 0 and trims; the noise of the padded
    # batch is the full batch's draw, so its 3 rows are the full batch's
    wavs, mel, lens = sharded(rows(batch, 3), generator=gen())
    check_equal((wavs, mel, lens), (want[0][:3], want[1][:3], want[2][:3]), dtype)


def test_mesh_pipeline_multispeaker_and_injected_noise():
    model, variables, _ = jax_multispeaker_generator("shallow", "DeepSpeaker")
    single, sharded = pipelines(model, variables, n=2)
    batch = speaker_batch(text_batch(B=4, P=16, seed=6), "DeepSpeaker")
    gen = lambda: torch.Generator().manual_seed(3)
    check_equal(sharded(batch, generator=gen()), single(batch, generator=gen()))
    r = np.random.RandomState(2)
    T = single.submit(batch).T
    noise = {"start_noise": r.randn(4, T, N_MELS).astype(np.float32),
             "step_noises": r.randn(model.schedule.num_timesteps, 4, T, N_MELS).astype(
                 np.float32)}
    check_equal(sharded(batch, noise_override=noise), single(batch, noise_override=noise))


def test_mesh_pipeline_matches_jax_mesh_pipeline():
    model, variables, _ = jax_generator("aux")
    jvoc, _ = vocoders()
    batch = text_batch(B=8, P=16, seed=4)
    want = JTTSPipeline(model, variables, jvoc, PRE_CONFIG, MODEL_CONFIG,
                        mesh=j_make_mesh(jax.devices()[:8], model_axis=1))(
        batch, rng=jax.random.PRNGKey(11))
    _, sharded = pipelines(model, variables)
    launches = fused_residual_stack.launches
    wavs, mel, lens = sharded(batch)
    assert fused_residual_stack.launches == launches   # the CPU takes the plain version
    np.testing.assert_array_equal(lens, want[2])
    np.testing.assert_allclose(mel, want[1], rtol=1e-4, atol=2e-2)
    for a, b in zip(wavs, want[0]):
        np.testing.assert_allclose(a.astype(np.int32), b.astype(np.int32), atol=2)


def test_serving_mesh_must_be_single_process_data_parallel():
    model, variables, _ = jax_generator("naive")
    _, tvoc = vocoders()
    port = torch_generator_like(model, variables)
    with pytest.raises(ValueError, match="model axis 1"):
        TTSPipeline(port, tvoc, PRE_CONFIG, MODEL_CONFIG,
                    mesh=make_mesh(["cpu"] * 4, model_axis=2))
    with pytest.raises(TypeError, match="mesh"):
        TTSPipeline(port, tvoc, PRE_CONFIG, MODEL_CONFIG, mesh="cpu")
    pipe = TTSPipeline(port, tvoc, PRE_CONFIG, MODEL_CONFIG, mesh=["cpu", "cpu"])
    assert [next(m.parameters()).device.type for m, _ in pipe.replicas] == ["cpu", "cpu"]
