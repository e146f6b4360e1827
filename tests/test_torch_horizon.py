"""The port's long-horizon drive (`tests/train_horizon_torch.py`) on the
CPU, as plumbing: its stages at 4 aux and 2 shallow steps (the step
counts are the only cut; the drive on the card runs 1500 and 1000), and
its corpus and configs (`tests/torch_horizon_helpers.py`) against the
JAX side's, which `tests/train_horizon.py` takes them from."""

import filecmp
import os
import shutil

import numpy as np
import pytest

import horizon_batches_torch as batches
import horizon_init_witness_torch as witness
import torch_horizon_helpers as helpers
import train_horizon_torch as horizon
from test_cli import TINY_MODEL_YAML, TINY_TRAIN_YAML
from test_data_pipeline import PREPROCESS_CONFIG, make_corpus
from test_multispeaker_e2e import make_multispeaker_corpus


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """workspace -> the port's preprocess CLI -> aux 4 -> shallow 2 from the
    aux checkpoint -> synthesize, each CLI in a subprocess on the CPU."""
    drive = horizon.Drive(str(tmp_path_factory.mktemp("horizon") / "ws"), device="cpu")
    return drive, horizon.aux_shallow(drive, aux_steps=4, shallow_steps=2)


def test_horizon_stages_run_on_the_cpu(stages):
    """The stages ran and their train log parses."""
    drive, (aux, sh, rdir) = stages
    assert [r["step"] for r in aux] == [1, 2, 3, 4]
    assert [r["step"] for r in sh] == [5, 6]
    assert horizon.all_finite(aux + sh)
    assert all(r["D"] == 0 for r in aux) and all(r["D"] > 0 for r in sh)
    assert drive.saved_steps("shallow") == [2, 4, 6]
    pcm = horizon.read_wav(rdir)
    assert len(pcm) > 1000 and np.isfinite(pcm).all()
    assert set(drive.walls) == {"pre", "aux", "shallow", "synth"}


def test_init_witness_vocodes_the_final_checkpoint_twice(stages):
    """`tests/horizon_init_witness_torch.py` on the stages' checkpoint: the
    same mel through the vocoder as built (the JAX package's initialisers),
    which is the synthesis CLI's wav, and redrawn with torch's defaults."""
    drive, (_, _, rdir) = stages
    out = witness.witness(drive.ws, "shallow", 6, device="cpu")
    assert sorted(out) == ["jax", "torch_default"]
    jax_init, torch_init = out["jax"]["0"], out["torch_default"]["0"]
    cli_wav = horizon.spectrum(horizon.read_wav(rdir))   # the CLI's, in another process
    assert jax_init["wav_samples"] == cli_wav["wav_samples"]
    for key in ("wav_std", "wav_interior_energy", "wav_band_energy"):
        np.testing.assert_allclose(jax_init[key], cli_wav[key], rtol=1e-3)
    assert jax_init["wav_samples"] == torch_init["wav_samples"]
    assert jax_init["wav_std"] != torch_init["wav_std"]
    assert all(0 <= v <= 1 for v in jax_init["wav_band_energy"] + torch_init["wav_band_energy"])


def test_horizon_corpus_and_configs_copy_the_jax_side(tmp_path):
    assert helpers.PREPROCESS_CONFIG == PREPROCESS_CONFIG
    assert helpers.TINY_MODEL_YAML == TINY_MODEL_YAML
    assert helpers.TINY_TRAIN_YAML == TINY_TRAIN_YAML
    for name, port, jax_side, kw, n_utts in (
            ("one", helpers.make_corpus, make_corpus, {"n_utts": 3}, 3),
            ("multi", helpers.make_multispeaker_corpus, make_multispeaker_corpus,
             {"n_speakers": 2, "n_utts": 2}, 4)):
        a, b = tmp_path / f"{name}_port", tmp_path / f"{name}_jax"
        port(str(a), **kw)
        jax_side(str(b), **kw)
        files = sorted(os.path.relpath(os.path.join(d, f), a)
                       for d, _, fs in os.walk(a) for f in fs)
        assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                               for d, _, fs in os.walk(b) for f in fs)
        assert len(files) == 3 * n_utts   # a wav, a .lab and a TextGrid each
        match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
        assert not mismatch and not errors and len(match) == len(files)


def test_batches_follow_the_held_out_utterances(stages, tmp_path):
    """`tests/horizon_batches_torch.py` on a copy of the stages' corpus: the
    batches of the steps hold no held-out utterance, follow the scheduler's
    buckets, and change with the held-out draw."""
    drive, _ = stages
    ws = str(tmp_path / "ws")
    shutil.copytree(drive.ws, ws, ignore=shutil.ignore_patterns("output"))
    got = {}
    for held in (["utt0"], ["utt23"]):
        facts = batches.batch_of_step(ws, 50, held)
        assert sorted(facts) == list(range(1, 51))
        assert not any(uid in f["ids"] for f in facts.values() for uid in held)
        assert all(f["bucket"] >= max(f["mel_lens"]) for f in facts.values())
        got[held[0]] = [f["ids"] for f in facts.values()]
    assert got["utt0"] != got["utt23"]
