"""A configuration brings its mode, speaker count and reference as files,
and the harness takes it unchanged (CPU).

The fixtures under `benchmark/tests/configs/`, `traffic/` and `limits/`
are not cells of BENCHMARK.json: an AISHELL3-shaped multi-speaker shallow
configuration (4 speakers, the speaker table, ids drawn from the seed) and
naive-mode LJSpeech (4 reverse steps from noise, `naive.Generator`).  Each
runs through `run.make_context` and the synth driver at the self-test's
tiny widths, and comes out correct; broken where the configuration's own
mechanism acts, it does not.  The last tests pin what the three cells read
(their weights, traffic and self-test numbers) to the values the harness
gave before configurations could name these.
"""

import argparse
import hashlib
import itertools
import os

import numpy as np
import pytest
import torch

from benchmark import core, run, traffic as T
from benchmark.checks import verdict
from benchmark.reference.discriminator import JCUDiscriminator as RefD
from benchmark.reference.hifigan import HiFiGAN
from benchmark.work import counts

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2 ** 31 + 19


def fixture(kind, name):
    return core.load_json(HERE, kind, name + ".json")


MULTI = fixture("configs", "aishell3_like_shallow_v2")
NAIVE = fixture("configs", "ljspeech_naive_v2")
SPEAKERS = fixture("traffic", "synth_b32_speakers")
SYNTH = core.load_json(core.HERE, "traffic", "synth_b32.json")


class Ticks:
    """A clock for the synth driver's window that moves 50 ms a reading:
    the window holds the same calls, and so the same sample, however busy
    the host is."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.05
        return self.now


def fixed_clock(monkeypatch):
    from benchmark.drivers import synth
    monkeypatch.setattr(synth, "time", Ticks())


def run_fixture(monkeypatch, config, traffic, limits, seed=SEED):
    """(correct, rows, driver output) of one run of a fixture configuration
    through the harness's context and driver at tiny widths, judged under
    the fixture limits `limits`."""
    fixed_clock(monkeypatch)
    monkeypatch.setattr(core, "limits_of", lambda name: fixture("limits", limits))
    cell = {"name": f"{config['name']}.fixture", "config": config["name"], "traffic": "fixture",
            "chips": 1}
    config, traffic = core.tiny(config, traffic)
    args = argparse.Namespace(workload=cell["name"], seed=seed, seconds=2, trace=0)
    ctx = run.make_context(args, cell, config, traffic, torch.device("cpu"))
    out = run.driver_of(traffic).run(ctx)
    correct, rows = verdict(out["checks"], ctx.limits)
    return correct and out["failed"] == 0, rows, out


# --- (a) speakers -------------------------------------------------------------------------

def test_multi_speaker_configuration_is_correct(monkeypatch):
    correct, rows, _ = run_fixture(monkeypatch, MULTI, SPEAKERS, "shallow")
    assert correct, rows


def test_multi_speaker_with_permuted_speakers_is_not_correct(monkeypatch):
    """The program is handed each batch with its speaker ids rolled by one
    row; the reference judges the batch as the traffic made it."""
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    submit = TTSPipeline.submit

    def rolled(self, batch, *args, **kwargs):
        return submit(self, dict(batch, speakers=np.roll(batch["speakers"], 1)), *args, **kwargs)

    monkeypatch.setattr(TTSPipeline, "submit", rolled)
    correct, rows, _ = run_fixture(monkeypatch, MULTI, SPEAKERS, "shallow")
    assert not correct, rows


def test_uniform_speakers_leave_the_other_draws_alone():
    uniform = list(itertools.islice(T.synth_stream(SPEAKERS, SEED, 360, n_speakers=218), 8))
    fixed = list(itertools.islice(T.synth_stream(SYNTH, SEED, 360), 8))
    for u, f in zip(uniform, fixed):
        assert all(np.array_equal(u[k], f[k]) for k in f if k != "speakers")
        assert (f["speakers"] == 0).all()
    ids = np.concatenate([u["speakers"] for u in uniform])
    assert ids.min() >= 0 and ids.max() < 218 and len(set(ids)) > 100


def test_a_fixed_speaker_outside_the_configuration_is_refused():
    with pytest.raises(ValueError, match="speaker 4"):
        T.speaker_ids(dict(SYNTH, speaker=4), None, 2, 4)


# --- (b) naive mode -----------------------------------------------------------------------

def test_naive_configuration_is_correct(monkeypatch):
    correct, rows, out = run_fixture(monkeypatch, NAIVE, SYNTH, "naive")
    assert correct, rows
    assert "coarse_mel_err" not in out["checks"]


def test_naive_without_its_last_reverse_step_is_not_correct(monkeypatch):
    """The program's reverse process stops at t = 1: x_1 stands for x_0."""
    from mixgantts_tpu_torch.models.diffusion import GaussianDiffusion

    def short(self, cond, spk_emb, noise, step_noises, return_trace=False):
        x = noise
        for k, i in enumerate(reversed(range(1, self.num_timesteps))):
            t = torch.full((cond.shape[0],), i, dtype=torch.long, device=cond.device)
            x0 = torch.clamp(self.denoise_fn(x, t, cond, spk_emb), -1.0, 1.0)
            x = self.q_posterior_sample(x0, x, t, step_noises[k])
        return x

    monkeypatch.setattr(GaussianDiffusion, "sampling", short)
    correct, rows, _ = run_fixture(monkeypatch, NAIVE, SYNTH, "naive")
    assert not correct, rows


def test_the_self_test_keeps_the_reverse_steps_and_the_speakers():
    config, _ = core.tiny(NAIVE, SYNTH)
    assert config["model"]["denoiser"]["timesteps"] == 4
    with torch.device("meta"):
        assert core.reference_generator(config).diffusion.num_timesteps == 4
        assert core.reference_generator(core.tiny(MULTI, SPEAKERS)[0]).speaker_emb.num_embeddings == 4


# --- (c) the work of a mode -------------------------------------------------------------------

def test_naive_kernel_parts_count_every_reverse_step():
    d, H = NAIVE["model"]["denoiser"], NAIVE["model"]["transformer"]["encoder_hidden"]
    one = counts.denoiser_work(32, 1000, d["residual_channels"], H, d["residual_layers"], 2,
                               hoisted=False)
    assert counts.kernel_parts(NAIVE, 32, 1000)["denoiser"] == (4 * one[0], 4 * one[1])
    shallow = counts.kernel_parts(dict(NAIVE, mode="shallow", reference="acoustic.Generator"),
                                  32, 1000)
    assert shallow["denoiser"] == one


def module_flops(config, monkeypatch):
    """{module: FLOP} of one call as `synth_flops` counts it, by the
    modules it calls (the generator's parts, the vocoder)."""
    from torch.utils.flop_counter import FlopCounterMode
    seen = {}

    def by_module(fn):
        with FlopCounterMode(display=False) as counter:
            fn()
        seen.update(counter.get_flop_counts())
        return counter.get_total_flops()

    monkeypatch.setattr(counts, "counted_flops", by_module)
    total = sum(counts.synth_flops(config, 2, 32, 16, 128))
    parts = {m: sum(f.values()) for m, f in seen.items() if "." not in m and m != "Global"}
    assert sum(parts.values()) == total
    return parts


def test_synth_flops_count_the_modules_of_the_mode(monkeypatch):
    """Naive mode counts no decoder, mel_linear or PostNet, and its
    denoiser four times shallow mode's one step at the same widths."""
    naive = module_flops(NAIVE, monkeypatch)
    shallow = module_flops(dict(NAIVE, mode="shallow", reference="acoustic.Generator"),
                           monkeypatch)
    assert set(naive) == {"LinguisticEncoder", "Denoiser", "HiFiGAN"}
    assert set(shallow) == set(naive) | {"Decoder", "Linear", "PostNet"}
    assert naive["Denoiser"] == 4 * shallow["Denoiser"]
    for m in ("LinguisticEncoder", "HiFiGAN"):
        assert naive[m] == shallow[m]


# --- what the harness refuses ----------------------------------------------------------------

def test_training_refuses_a_mode_without_a_training_reference():
    with pytest.raises(ValueError, match="train_step.py trains shallow mode"):
        core.program_train(NAIVE, torch.device("cpu"), 1, 2, 0)


def test_a_reference_in_another_mode_is_refused():
    with pytest.raises(ValueError, match="'naive' mode"):
        core.reference_of(dict(NAIVE, reference="acoustic.Generator"))


def test_a_traffic_without_tiny_sizes_is_refused_by_the_self_test():
    with pytest.raises(ValueError, match="'tiny' key"):
        core.tiny(NAIVE, dict(SYNTH, driver="serve"))
    assert core.tiny(NAIVE, SPEAKERS)[1]["batch"] == 4
    assert "tiny" not in core.tiny(NAIVE, SPEAKERS)[1]


# --- (e) a number the run did not compute -------------------------------------------------------

def test_a_limit_on_a_number_not_computed_is_not_correct(monkeypatch):
    correct, rows, _ = run_fixture(monkeypatch, NAIVE, SYNTH, "shallow")
    assert not correct
    assert dict((k, v) for k, v, _ in rows)["coarse_mel_err"] == float("inf")


# --- (d) what the three cells read, as before ------------------------------------------------------

def digest(items):
    h = hashlib.sha256()
    for key, a in items:
        a = np.ascontiguousarray(a)
        for part in (key, str(a.shape), str(a.dtype)):
            h.update(part.encode())
        h.update(a.tobytes())
    return h.hexdigest()


# the values of the harness before this change, on the CPU
WEIGHTS = {
    ("ljspeech_shallow_v1", "G"): "19afa1c2358570d4b8fcd2f236a71919ed459068da09a300a8707cf60ecb6fcd",
    ("ljspeech_shallow_v1", "V"): "0820abfd3e7677aba663b3bc0cbdefafefc4215a6882e58b14d38d0bba0874c9",
    ("ljspeech_shallow_v1", "D"): "5dc8aa5f2743f6b76d6efc425d6ec9a42ad2ed3773e509679233cb286e265154",
    ("ljspeech_shallow_v2", "G"): "19afa1c2358570d4b8fcd2f236a71919ed459068da09a300a8707cf60ecb6fcd",
    ("ljspeech_shallow_v2", "V"): "fa7d54e48f2559c2ec17fa2a7bb7aa7b19b8aa1edb5cebfa7f72e10fb1a9673e",
    ("ljspeech_shallow_v2", "D"): "5dc8aa5f2743f6b76d6efc425d6ec9a42ad2ed3773e509679233cb286e265154",
}
BATCHES = {
    ("synth_b32", 3): "1cb6e2058774d033b6eb844e95276fa0fcacbc047142d526a14bd13eb7905471",
    ("synth_b32", 2 ** 31 + 12345): "94fc619a0fd7d5afc139b26cbf5536c104abadc2648dec243ca4d17b1729b576",
    ("train_b64", 3): "8888260eb91e7d9a6c9d21c64db44c3f8d8bf1ff148266f35bff62d66db5aeed",
    ("train_b64", 2 ** 31 + 12345): "b6fc31fe2fa9c3d502078868dbefe42719f9bb8a49813f5ea9cc315d15bfe95b",
}
CHECKS = {   # run.self_test at seed 2**31 + 77
    "lj_v1.synth_b32": {"decision_gap": 0.0, "features_err": 0.0, "coarse_mel_err": 0.0,
                        "mel_err": 0.0, "wave_err": 0.0009356860118911281},
    "lj_v2.synth_b32": {"decision_gap": 0.0, "features_err": 0.0, "coarse_mel_err": 0.0,
                        "mel_err": 0.0, "wave_err": 0.0009356860118911281},
    "lj_v1.train_b64": {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0},
}


@pytest.mark.parametrize("name, part", sorted(WEIGHTS))
def test_weights_of_the_cells_are_unchanged(name, part):
    config = core.load_json(core.HERE, "configs", name + ".json")
    rc = core.ref_config(config)
    with torch.device("meta"):
        module = {"G": lambda: core.reference_generator(config),
                  "V": lambda: HiFiGAN(config["hifigan"]),
                  "D": lambda: RefD(rc["n_mels"], rc["denoiser"]["residual_channels"],
                                    rc["discriminator"])}[part]()
    seed = 2 ** 31 + 5 if part == "G" else core.sub_seed(2 ** 31 + 5, part)
    weights = core.make_weights(core.shapes_of(module), config, seed, torch.device("cpu"))
    assert digest((k, v.numpy()) for k, v in weights.items()) == WEIGHTS[name, part]


@pytest.mark.parametrize("traffic, seed", sorted(BATCHES))
def test_first_20_batches_of_the_traffic_are_unchanged(traffic, seed):
    config = core.load_json(core.HERE, "configs", "ljspeech_shallow_v1.json")
    spec = core.load_json(core.HERE, "traffic", traffic + ".json")
    if traffic == "synth_b32":
        batches = itertools.islice(T.synth_stream(spec, seed, config["n_symbols"],
                                                  core.n_speakers(config)), 20)
    else:
        batches = T.train_pool(dict(spec, pool=20), seed, config)
    got = digest((f"{i}.{k}", b[k]) for i, b in enumerate(batches) for k in sorted(b))
    assert got == BATCHES[traffic, seed]


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_self_test_numbers_of_the_cells_are_unchanged(name, monkeypatch):
    fixed_clock(monkeypatch)
    cell, config, traffic, _ = core.find_cell(name)
    args = argparse.Namespace(workload=name, seed=2 ** 31 + 77, seconds=2, trace=0)
    out, correct = run.self_test(args, cell, config, traffic)
    assert correct
    assert {k: float(v) for k, v in out["checks"].items()} == CHECKS[name]
