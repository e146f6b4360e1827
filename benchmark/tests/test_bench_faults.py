"""A run with its timed path broken underneath comes out not correct.

Each test skips the look for a chip (the drivers' CPU self-test at tiny
widths), breaks the program where it produces its answer, drives the rest
of a run, and sees `correct` false under the cell's own limits: for each
fault a cell can have on one chip (no exchange between chips runs)."""

import argparse

import pytest
import torch

from benchmark import run
from benchmark.core import find_cell


def run_cell(name, seed=2 ** 31 + 9):
    cell, config, traffic, _ = find_cell(name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=1, trace=0)
    return run.self_test(args, cell, config, traffic)


def patch_vocoder(monkeypatch, alter):
    from mixgantts_tpu_torch.models import hifigan
    forward = hifigan.HiFiGANGenerator.forward
    monkeypatch.setattr(hifigan.HiFiGANGenerator, "forward",
                        lambda self, mel: alter(forward(self, mel)))


def scale_row0(wave):
    return torch.cat([wave[:1] * 0.5, wave[1:]])


def drop_second_half(wave):
    half = wave.shape[0] // 2
    return torch.cat([wave[:half], torch.zeros_like(wave[half:])])


@pytest.mark.parametrize("cell", ["lj_v1.synth_b32", "lj_v2.synth_b32"])
def test_synthesis_unbroken_is_correct(cell):
    assert run_cell(cell)[1]


@pytest.mark.parametrize("cell", ["lj_v1.synth_b32", "lj_v2.synth_b32"])
@pytest.mark.parametrize("fault", [scale_row0, drop_second_half],
                         ids=["an_answer_altered", "half_the_batch_left_out"])
def test_synthesis_fault_is_not_correct(cell, fault, monkeypatch):
    patch_vocoder(monkeypatch, fault)
    assert not run_cell(cell)[1]


def test_synthesis_altered_mel_is_not_correct(monkeypatch):
    """An answer altered where the acoustic model produces it."""
    from mixgantts_tpu_torch.models import diffusion
    sampling = diffusion.GaussianDiffusion.sampling
    monkeypatch.setattr(diffusion.GaussianDiffusion, "sampling",
                        lambda self, *a, **k: sampling(self, *a, **k) * 0.9)
    assert not run_cell("lj_v1.synth_b32")[1]


def test_training_unbroken_is_correct():
    assert run_cell("lj_v1.train_b64")[1]


def test_training_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from mixgantts_tpu_torch.train import optim
    monkeypatch.setattr(optim.Adam, "step", lambda self, lr=None: False)
    assert not run_cell("lj_v1.train_b64")[1]


def test_training_on_half_the_batch_is_not_correct(monkeypatch):
    import mixgantts_tpu_torch.train as train
    make = train.make_train_step

    def half_step(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def step(state, batch, noise_overrides=None):
            rows = next(iter(batch.values())).shape[0] // 2
            return step_fn(state, {k: v[:rows] for k, v in batch.items()}, noise_overrides)
        return step

    monkeypatch.setattr(train, "make_train_step", half_step)
    assert not run_cell("lj_v1.train_b64")[1]
