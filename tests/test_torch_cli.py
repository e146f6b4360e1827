"""The port's synthesis CLI (`mixgantts_tpu_torch.cli.synthesize`) on the
CPU, at test_cli.py's small config (TINY_MODEL_YAML):

- generator weights made on the JAX side, written as a reference
  `.pth.tar` by `mixgantts_tpu.export`, restored by the port's CLI with
  `strict=True` over every parameter;
- `--mode single` and `--mode batch --source` write int16 wavs at the
  corpus's rate that are bit-equal to the port's `TTSPipeline` fed with
  the JAX frontend's ids (same weights, batch i seeded with i);
- `--model aux`, which draws no noise, agrees with the JAX package's
  `TTSPipeline` on the same weights within test_torch_pipeline.py's
  tolerance (int16 within 1 LSB, mel mean |diff| < 1e-3);
- `--data_parallel` batch synthesis over a mesh of the visible devices
  writes the same wavs;
- the probes: single mode without text, shallow below total_step_aux,
  teacher-forced synthesis from a source file, no GPU, no checkpoint.

The vocoder is test_torch_pipeline.py's tiny HiFi-GAN on both sides.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from mixgantts_tpu import frontend as jfront
from mixgantts_tpu.cli import common as jcommon
from mixgantts_tpu.data.dataset import TextOnlyDataset as JTextOnlyDataset
from mixgantts_tpu.export import export_generator
from mixgantts_tpu.pipeline import TTSPipeline as JTTSPipeline
from mixgantts_tpu.text import sequence_to_text
from mixgantts_tpu_torch.cli import common as tcommon
from mixgantts_tpu_torch.cli import synthesize as tsyn
from mixgantts_tpu_torch.convert import generator_state_dict, load_reference_generator
from mixgantts_tpu_torch.pipeline import TTSPipeline
from mixgantts_tpu_torch.utils import synth as tsynth
from test_cli import TINY_MODEL_YAML, TINY_TRAIN_YAML
from test_data_pipeline import PREPROCESS_CONFIG
from test_torch_pipeline import HOP, vocoders
from torch_port_helpers import init_jax_generator, text_batch

SR = PREPROCESS_CONFIG["preprocessing"]["audio"]["sampling_rate"]
STEPS = {"naive": 4, "shallow": 4, "aux": 2}   # aux and shallow share a directory
SOURCE = ["hello world", "hello, brave new world!", "world"]


def configs(root):
    pre = copy.deepcopy(PREPROCESS_CONFIG)
    pre["preprocessing"]["stft"]["hop_length"] = HOP   # the tiny vocoder's hop
    pre["path"] = {"lexicon_path": os.path.join(root, "lexicon.txt"),
                   "preprocessed_path": os.path.join(root, "preprocessed")}
    train = copy.deepcopy(TINY_TRAIN_YAML)
    train["path"] = {k: os.path.join(root, "output", k[:-5], "TestCorpus")
                     for k in ("ckpt_path", "log_path", "result_path")}
    return pre, copy.deepcopy(TINY_MODEL_YAML), train


def jax_generator(mode, pre, mc):
    """A JAX generator of the tiny config with random weights, and its
    reference-format G state_dict."""
    model, stats = jcommon.build_model(mode, pre, mc)
    variables = init_jax_generator(model, text_batch(), 32, seed=STEPS[mode])
    keep = mc["denoiser"]["keep_bins"]
    G = export_generator(variables["params"], variables.get("batch_stats", {}),
                         betas=model.schedule.betas,
                         spec_min=np.asarray(stats.spec_min[:keep]),
                         spec_max=np.asarray(stats.spec_max[:keep]),
                         model_config=mc, stats=stats)
    return model, variables, G


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """config/TestCorpus/*.yaml, a two-word lexicon, speakers.json, the
    phones per word of a 3-line source file, and one exported checkpoint
    per mode; the working directory is the workspace while the tests run."""
    root = str(tmp_path_factory.mktemp("torch_cli_ws"))
    pre, mc, train = configs(root)
    cfg_dir = os.path.join(root, "config", "TestCorpus")
    os.makedirs(cfg_dir)
    for name, cfg in (("preprocess.yaml", pre), ("model.yaml", mc), ("train.yaml", train)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.dump(cfg, f)
    with open(pre["path"]["lexicon_path"], "w") as f:
        f.write("hello HH AH0 L OW1\nworld W ER1 L D\n")
    pp = pre["path"]["preprocessed_path"]
    os.makedirs(os.path.join(pp, "phones_per_word"))
    with open(os.path.join(pp, "speakers.json"), "w") as f:
        json.dump({"spk0": 0}, f)
    lines = []
    for i, raw in enumerate(SOURCE):
        seq, wb = jfront.preprocess_english(raw, pre, verbose=False)
        np.save(os.path.join(pp, "phones_per_word", f"spk0-phones_per_word-utt{i}.npy"), wb)
        lines.append(f"utt{i}|spk0|{sequence_to_text(seq.tolist())}|{raw}")
    with open(os.path.join(root, "source.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    generators = {}
    for mode, step in STEPS.items():
        model, variables, G = jax_generator(mode, pre, mc)
        ckpt_dir = jcommon.route_paths(copy.deepcopy(train), mode)["path"]["ckpt_path"]
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save({"epoch": 1, "G": {k: torch.from_numpy(np.array(v)) for k, v in G.items()}},
                   os.path.join(ckpt_dir, f"{step}.pth.tar"))
        generators[mode] = (model, variables, G)
    cwd = os.getcwd()
    os.chdir(root)
    yield {"root": root, "pre": pre, "mc": mc, "train": train, "generators": generators}
    os.chdir(cwd)


@pytest.fixture
def port_vocoder(monkeypatch):
    """The CLI builds test_torch_pipeline.py's tiny HiFi-GAN."""
    _, tvoc = vocoders()
    monkeypatch.setattr(tsyn, "get_vocoder", lambda *args, **kwargs: tvoc)
    return tvoc


def run_cli(mode, *extra):
    return tsyn.cli(["--restore_step", str(STEPS[mode]), "--model", mode,
                     "--dataset", "TestCorpus", *extra], device="cpu")


def read_wav(path):
    sr, wav = wavfile.read(path)
    assert sr == SR and wav.dtype == np.int16
    return wav


def port_pipeline(ws, mode, vocoder):
    """The port's pipeline on the generator the CLI restores."""
    model, _ = tcommon.build_model(mode, ws["pre"], ws["mc"], device="cpu")
    tcommon.restore_generator(
        model, tcommon.route_paths(copy.deepcopy(ws["train"]), mode)["path"]["ckpt_path"],
        STEPS[mode])
    return TTSPipeline(model, vocoder, ws["pre"], ws["mc"])


def single_batch(ws, text):
    seq, wb = jfront.preprocess_english(text, ws["pre"], verbose=False)
    return {"speakers": np.array([0]), "texts": seq[None], "src_lens": np.array([len(seq)]),
            "word_boundaries": wb[None], "src_w_lens": np.array([len(wb)])}


@pytest.mark.parametrize("mode", ["naive", "shallow"])
def test_restore_is_strict_and_equals_the_bridge(workspace, mode):
    """The restored tensors are the JAX weights (the bridge's own
    conversion); an unknown key, or buffers derived from other statistics,
    refuse to load."""
    model, variables, G = workspace["generators"][mode]
    port = port_pipeline(workspace, mode, vocoders()[1]).model
    want = generator_state_dict(variables["params"], variables.get("batch_stats", {}))
    got = port.state_dict()
    assert set(got) == set(want)
    for k in want:   # exact (torch.equal: no lazy imports that other files' stubs can break)
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    G = {k: torch.from_numpy(np.array(v)) for k, v in G.items()}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_generator(port, dict(G, extra=torch.zeros(1)))
    moved = dict(G, **{"diffusion.spec_min": G["diffusion.spec_min"] - 1.0})
    with pytest.raises(ValueError, match="diffusion.spec_min"):
        load_reference_generator(port, moved)


@pytest.mark.parametrize("mode", ["naive", "shallow"])
def test_single_mode_writes_the_pipeline_wav(workspace, port_vocoder, mode):
    text = "Hello world, hello columns!"
    written = run_cli(mode, "--mode", "single", "--text", text)
    assert len(written) == 1
    path, mel_len = written[0]
    assert path == os.path.join(workspace["train"]["path"]["result_path"] + f"_{mode}",
                                str(STEPS[mode]), f"{text}.wav")
    wav = read_wav(path)
    assert mel_len > 0 and len(wav) == mel_len * HOP
    pipe = port_pipeline(workspace, mode, port_vocoder)
    (want,), _, lens = pipe(single_batch(workspace, text))
    assert int(lens[0]) == mel_len
    np.testing.assert_array_equal(wav, want)


def test_batch_mode_writes_the_pipeline_wavs(workspace, port_vocoder):
    written = run_cli("shallow", "--mode", "batch", "--source", "source.txt")
    assert [os.path.basename(p) for p, _ in written] == [f"utt{i}.wav" for i in range(3)]
    batch = next(JTextOnlyDataset("source.txt", workspace["pre"], workspace["mc"]).batches(8))
    wants, _, lens = port_pipeline(workspace, "shallow", port_vocoder)(batch)
    for (path, mel_len), want, n in zip(written, wants, lens):
        wav = read_wav(path)
        assert mel_len == int(n) > 0 and len(wav) == mel_len * HOP
        np.testing.assert_array_equal(wav, want)


def test_batch_mode_data_parallel_writes_the_pipeline_wavs(workspace, port_vocoder):
    """`--data_parallel` serves the batch over a mesh of every visible
    device (the CPU here: one replica), drawing the noise the plain
    pipeline draws: the same wavs."""
    written = run_cli("shallow", "--mode", "batch", "--source", "source.txt",
                      "--data_parallel")
    batch = next(JTextOnlyDataset("source.txt", workspace["pre"], workspace["mc"]).batches(8))
    wants, _, lens = port_pipeline(workspace, "shallow", port_vocoder)(batch)
    assert len(written) == len(wants) == 3
    for (path, mel_len), want, n in zip(written, wants, lens):
        wav = read_wav(path)
        assert mel_len == int(n) > 0
        np.testing.assert_array_equal(wav, want)


def test_aux_mode_matches_the_jax_pipeline(workspace, port_vocoder):
    text = "hello brave world"
    (path, mel_len), = run_cli("aux", "--mode", "single", "--text", text)
    wav = read_wav(path)
    model, variables, _ = workspace["generators"]["aux"]
    jvoc, _ = vocoders()
    batch = single_batch(workspace, text)
    jpipe = JTTSPipeline(model, variables, jvoc, workspace["pre"], workspace["mc"],
                         mel_dtype=np.float32)
    (want,), want_mel, want_lens = jpipe(batch)
    assert int(want_lens[0]) == mel_len and wav.shape == want.shape
    assert np.abs(wav.astype(np.int32) - want.astype(np.int32)).max() <= 1
    _, mel, _ = port_pipeline(workspace, "aux", port_vocoder)(batch)
    assert np.abs(mel - np.asarray(want_mel)).mean() < 1e-3


def test_write_results_without_matplotlib(workspace, monkeypatch, tmp_path):
    """Where matplotlib does not import, the wavs are written, the figures
    skipped, and a warning says so."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = type("Args", (), {"restore_step": 7, "mode": "batch"})()
    mels = np.zeros((2, 5, 20), np.float32)
    wavs = [np.arange(16, dtype=np.int16), np.arange(8, dtype=np.int16)]
    with pytest.warns(UserWarning, match="matplotlib is not installed"):
        paths = tsynth.write_results(args, ["a", "b"], mels, [2, 1], wavs, workspace["mc"],
                                     workspace["pre"], str(tmp_path))
    assert sorted(os.listdir(tmp_path / "7")) == ["a.wav", "b.wav"]
    np.testing.assert_array_equal(read_wav(paths[0]), wavs[0])


@pytest.mark.parametrize("argv,error,match", [
    (["--restore_step", "4", "--model", "naive", "--mode", "single"],
     AssertionError, None),
    (["--restore_step", "2", "--model", "shallow", "--mode", "single", "--text", "hi"],
     AssertionError, "finished aux checkpoint"),
    (["--restore_step", "4", "--model", "naive", "--mode", "batch", "--teacher_forced",
      "--source", "source.txt"], AssertionError, None),
    (["--restore_step", "6", "--model", "naive", "--mode", "single", "--text", "hi"],
     FileNotFoundError, "pth.tar"),
])
def test_cli_probes_raise(workspace, port_vocoder, argv, error, match):
    with pytest.raises(error, match=match):
        tsyn.cli(argv + ["--dataset", "TestCorpus"], device="cpu")


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.cli(["--restore_step", "4", "--model", "naive", "--mode", "single",
                  "--text", "hi", "--dataset", "TestCorpus"])
