"""The reverse steps of inference (`GaussianDiffusion.sampling`) under the
profiler, on the CPU at tiny widths of the packaged LJSpeech configuration:
each step is a `diffusion.step` span inside `model.diffusion` (four a
naive call, one a shallow call) and counts in `reverse_steps`; a training
step samples none; a naive call's outputs are bitwise the same with the
profiler on and off (`tests/test_torch_spans.py` holds a shallow call's).
"""

import numpy as np
import pytest

from test_torch_spans import check_nesting, configs, pipeline, profiled, synthesize, train, trainer

STEPS = {"naive": 4, "shallow": 1}   # the packaged denoiser's timesteps, shallow_timesteps


@pytest.fixture(scope="module")
def pipes():
    return {mode: pipeline(mode) for mode in STEPS}


def test_the_packaged_configuration_runs_these_steps():
    d = configs()[1]["denoiser"]
    assert (d["timesteps"], d["shallow_timesteps"]) == (STEPS["naive"], STEPS["shallow"])


@pytest.mark.parametrize("mode", STEPS)
def test_each_reverse_step_is_a_span_inside_the_diffusion_branch(pipes, mode):
    _, spans = profiled(synthesize, pipes[mode])
    check_nesting(spans, {"diffusion.step": "model.diffusion",
                          "kernel.fused_residual_stack": "diffusion.step"})
    names = [s[0] for s in spans]
    assert names.count("model.diffusion") == 1
    assert names.count("diffusion.step") == names.count("kernel.fused_residual_stack") \
        == STEPS[mode]


@pytest.mark.parametrize("mode", STEPS)
def test_reverse_steps_counts_the_steps_a_call_runs(pipes, mode):
    diffusion = pipes[mode].model.diffusion
    before = diffusion.reverse_steps
    synthesize(pipes[mode])
    assert diffusion.reverse_steps - before == STEPS[mode]
    profiled(synthesize, pipes[mode])
    assert diffusion.reverse_steps - before == 2 * STEPS[mode]


def test_a_training_step_runs_no_reverse_step():
    state, chunk_fn = trainer()
    _, spans = profiled(train, state, chunk_fn)
    names = [s[0] for s in spans]
    assert "model.diffusion" in names and "diffusion.step" not in names
    assert state.model.diffusion.reverse_steps == 0


def test_naive_outputs_bitwise_equal_with_the_profiler_on_and_off(pipes):
    wavs, mel, lens = synthesize(pipes["naive"])
    (wavs_on, mel_on, lens_on), _ = profiled(synthesize, pipes["naive"])
    assert np.array_equal(lens, lens_on) and np.array_equal(mel, mel_on)
    assert all(np.array_equal(a, b) for a, b in zip(wavs, wavs_on))
