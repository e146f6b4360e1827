"""The port's audio features and preprocessing (`mixgantts_tpu_torch/audio/`,
`data/{textgrid,ljspeech,aishell3,preprocessor}.py`,
`models/speaker_embedder.py`, `cli/{prepare_align,preprocess}.py`) against
the JAX package's, on the CPU.

- The Slaney basis, `get_mel_from_wav`, both F0 trackers,
  `interpolate_unvoiced`, the f0 quantisation and normalisations, the CWT
  and Griffin-Lim equal JAX's exactly (the same numpy); the batched
  `mel_spectrogram` (torch) equals JAX's `_mel_energy` at rtol 1e-5.
- TextGrids written by either package read back the same in both.
- `prepare_align` (LJSpeech and AISHELL3 layouts, through the port's CLI)
  writes byte-equal .lab files and equal int16 wavs.
- The whole `Preprocessor` on test_data_pipeline.py's single-speaker
  corpus (through the port's CLI) and on a two-speaker corpus with the
  DeepSpeaker embedder (the port's carrying the JAX embedder's weights
  through `convert.deepspeaker_state_dict`), Python's and numpy's global
  RNGs seeded the same before each run: every .npy equal to JAX's at rtol
  1e-6, `spker_embed` at rtol 1e-4 (one conv net in two frameworks);
  stats.json, speakers.json, train.txt, val.txt and filtered_out.txt
  identical.
- DeepSpeaker through the bridge against `DeepSpeakerResCNN.apply` at rtol
  1e-4, and `PreDefinedEmbedder` end to end under the same numpy seed.
- The port's `AcousticDataset` over the port's output gives the batches
  JAX's gives over JAX's output.
"""

import copy
import json
import os
import random

import flax.linen
import jax
import numpy as np
import pytest
import torch
import yaml

from mixgantts_tpu.audio import f0 as jf0
from mixgantts_tpu.audio.mel import mel_filterbank as j_mel_filterbank
from mixgantts_tpu.audio.stft import TacotronSTFT as JTacotronSTFT
from mixgantts_tpu.audio.stft import _mel_energy
from mixgantts_tpu.data import aishell3 as jaishell3
from mixgantts_tpu.data import ljspeech as jljspeech
from mixgantts_tpu.data import textgrid as jtextgrid
from mixgantts_tpu.data.dataset import AcousticDataset as JAcousticDataset
from mixgantts_tpu.data.preprocessor import Preprocessor as JPreprocessor
from mixgantts_tpu.models import speaker_embedder as jembedder
from mixgantts_tpu_torch.audio import f0
from mixgantts_tpu_torch.audio.mel import mel_filterbank
from mixgantts_tpu_torch.audio.stft import TacotronSTFT
from mixgantts_tpu_torch.audio.wav import save_wav
from mixgantts_tpu_torch.cli import prepare_align as cli_prepare_align
from mixgantts_tpu_torch.cli import preprocess as cli_preprocess
from mixgantts_tpu_torch.convert import deepspeaker_state_dict
from mixgantts_tpu_torch.data import textgrid
from mixgantts_tpu_torch.data.dataset import AcousticDataset
from mixgantts_tpu_torch.data.preprocessor import Preprocessor
from mixgantts_tpu_torch.models import speaker_embedder
from test_cli import TINY_MODEL_YAML, TINY_TRAIN_YAML
from test_data_pipeline import MODEL_CONFIG, PREPROCESS_CONFIG, SR, make_corpus
from test_multispeaker_e2e import make_multispeaker_corpus
from torch_port_helpers import assert_close


def tone(seconds=0.6, seed=0):
    """A voiced test signal: a gliding harmonic tone with noise and a
    silent gap (so both trackers see unvoiced frames)."""
    r = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    hz = 120 + 80 * t
    phase = 2 * np.pi * np.cumsum(hz) / SR
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase)
    wav[len(wav) // 2:len(wav) // 2 + SR // 20] = 0.0
    return (wav + 0.005 * r.randn(len(t))).astype(np.float32)


def write_configs(root, dataset, pre, mc=MODEL_CONFIG, tc=None):
    """config/<dataset>/*.yaml under `root`, which the CLIs read from the
    working directory."""
    cfg_dir = os.path.join(root, "config", dataset)
    os.makedirs(cfg_dir, exist_ok=True)
    tc = tc or {"optimizer": {"batch_size": 2, "batch_size_shallow": 2}}
    for name, cfg in (("preprocess.yaml", pre), ("model.yaml", mc), ("train.yaml", tc)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.dump(cfg, f)


def corpus_config(root, dataset="TestCorpus", embedder="none"):
    pre = copy.deepcopy(PREPROCESS_CONFIG)
    pre["dataset"] = dataset
    pre["preprocessing"]["speaker_embedder"] = embedder
    pre["path"] = {"corpus_path": root, "raw_path": os.path.join(root, "raw_data"),
                   "preprocessed_path": os.path.join(root, "preprocessed")}
    return pre


def seeded():
    random.seed(0)
    np.random.seed(0)


EMBEDDER_CONFIG = {"preprocessing": dict(PREPROCESS_CONFIG["preprocessing"],
                                          speaker_embedder="DeepSpeaker")}


def jax_embedder_variables():
    """The JAX `PreDefinedEmbedder`'s weights (its random init from
    PRNGKey(0)) as numpy trees."""
    return jax.device_get(jembedder.PreDefinedEmbedder(EMBEDDER_CONFIG).variables)


def load_jax_weights(embedder, variables):
    embedder.module.load_state_dict(
        deepspeaker_state_dict(variables["params"], variables["batch_stats"]), strict=True)


@pytest.fixture(scope="module", autouse=True)
def jitted_embedder_init():
    """The JAX embedder's flax init jitted (the same function and key):
    ~1 s on the CPU against ~10 s op by op."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jembedder.DeepSpeakerResCNN, "init",
                   lambda self, rng, x: jax.jit(flax.linen.Module.init, static_argnums=0)(
                       self, rng, x))
        yield


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """{"single": (port root, JAX root, pre config), "multi": ...}: the same
    corpora preprocessed by each package.  The single-speaker port run goes
    through `cli.preprocess`."""
    out = {}
    base = tmp_path_factory.mktemp("torch_preprocess")
    roots = {kind: (str(base / f"{kind}_port"), str(base / f"{kind}_jax"))
             for kind in ("single", "multi")}
    cwd = os.getcwd()
    for root in roots["single"]:
        make_corpus(root)
    port_root, jax_root = roots["single"]
    seeded()
    JPreprocessor(corpus_config(jax_root), MODEL_CONFIG, {}).build_from_path()
    write_configs(port_root, "TestCorpus", corpus_config(port_root))
    os.chdir(port_root)
    try:
        seeded()
        cli_preprocess.cli(["--dataset", "TestCorpus"], device="cpu")
    finally:
        os.chdir(cwd)
    out["single"] = (port_root, jax_root, corpus_config(port_root))

    for root in roots["multi"]:
        make_multispeaker_corpus(root, n_speakers=2, n_utts=3)
    port_root, jax_root = roots["multi"]
    mc = dict(MODEL_CONFIG, multi_speaker=True)
    seeded()
    jpre = JPreprocessor(corpus_config(jax_root, embedder="DeepSpeaker"), mc, {})
    jpre.build_from_path()
    pre = Preprocessor(corpus_config(port_root, embedder="DeepSpeaker"), mc, {}, device="cpu")
    load_jax_weights(pre.speaker_emb, jax.device_get(jpre.speaker_emb.variables))
    seeded()
    pre.build_from_path()
    out["multi"] = (port_root, jax_root, corpus_config(port_root, embedder="DeepSpeaker"))
    return out


@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [(22050, 1024, 80, 8000), (22050, 256, 20, 8000),
                                                  (16000, 512, 40, None)])
def test_mel_filterbank_equals_jax(sr, n_fft, n_mels, fmax):
    np.testing.assert_array_equal(mel_filterbank(sr, n_fft, n_mels, 0.0, fmax),
                                  j_mel_filterbank(sr, n_fft, n_mels, 0.0, fmax))


def test_mel_spectrogram_matches_jax_and_host():
    """The batched torch path against JAX's `_mel_energy` (rtol 1e-5), and
    the host `get_mel_from_wav` equal to JAX's."""
    args = (1024, 256, 1024, 80, SR, 0.0, 8000)
    wavs = np.stack([tone(1.0, seed=s) for s in range(2)])
    stft, jstft = TacotronSTFT(*args, device="cpu"), JTacotronSTFT(*args)
    mel, energy = stft.mel_spectrogram(wavs)
    want_mel, want_energy = _mel_energy(wavs, 1024, 256, 1024, 80, SR, 8000)
    assert mel.dtype == energy.dtype == torch.float32 and mel.shape == want_mel.shape
    assert_close(mel, np.asarray(want_mel), rtol=1e-5, atol=1e-5, msg="mel")
    assert_close(energy, np.asarray(want_energy), rtol=1e-5, atol=1e-6, msg="energy")
    for got, want in zip(stft.get_mel_from_wav(wavs[0]), jstft.get_mel_from_wav(wavs[0])):
        np.testing.assert_array_equal(got, want)
    mel1, _ = stft.mel_spectrogram(torch.from_numpy(wavs[1]))
    assert_close(mel1[0], np.asarray(want_mel[1]), rtol=1e-5, atol=1e-5, msg="[T] input")


def test_griffin_lim_equals_jax():
    args = (256, 64, 256, 20, SR, 0.0, 8000)
    mel, _ = JTacotronSTFT(*args).get_mel_from_wav(tone(0.3))
    np.testing.assert_array_equal(TacotronSTFT(*args).inv_mel_spec(mel, n_iters=3),
                                  JTacotronSTFT(*args).inv_mel_spec(mel, n_iters=3))


@pytest.mark.parametrize("tracker", ["extract_f0", "extract_f0_dio"])
def test_f0_trackers_equal_jax(tracker):
    wav = tone()
    got, want = getattr(f0, tracker)(wav, SR, 256), getattr(jf0, tracker)(wav, SR, 256)
    assert (want > 0).any() and (want == 0).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(f0.interpolate_unvoiced(got.copy()),
                                  jf0.interpolate_unvoiced(want.copy()))


def test_f0_helpers_equal_jax():
    """Coarse quantisation, the f0 normalisations and the CWT round trip."""
    pitch = jf0.extract_f0(tone(), SR, 256)
    uv = pitch == 0
    np.testing.assert_array_equal(f0.f0_to_coarse(pitch), jf0.f0_to_coarse(pitch))
    for norm in ("log", "standard"):
        kw = dict(pitch_norm=norm, f0_mean=150.0, f0_std=30.0)
        got, want = f0.norm_f0(pitch.copy(), uv, **kw), jf0.norm_f0(pitch.copy(), uv, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(f0.denorm_f0(got, uv, **kw), jf0.denorm_f0(want, uv, **kw))
    for a, b in zip(f0.norm_interp_f0(pitch.copy()), jf0.norm_interp_f0(pitch.copy())):
        np.testing.assert_array_equal(a, b)
    lf0 = np.log(np.where(uv, 100.0, pitch))
    (got, scales), (want, jscales) = f0.get_lf0_cwt(lf0), jf0.get_lf0_cwt(lf0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scales, jscales)
    np.testing.assert_array_equal(f0.inverse_cwt(got, scales), jf0.inverse_cwt(want, jscales))


def test_textgrid_round_trip(tmp_path):
    """A TextGrid written by either package reads back
    the same in both."""
    tiers = [("words", [(0.0, 0.5, 'say hi'), (0.5, 1.25, "")]),
             ("phones", [(0.0, 0.25, "S"), (0.25, 0.5, "EY1"), (0.5, 1.25, "sil")])]
    for writer in (textgrid, jtextgrid):
        path = str(tmp_path / f"{writer.__name__}.TextGrid")
        writer.write_textgrid(path, [writer.IntervalTier(n, iv) for n, iv in tiers], xmax=1.25)
        got, want = textgrid.read_textgrid(path), jtextgrid.read_textgrid(path)
        for name, intervals in tiers:
            assert got.get_tier_by_name(name).intervals == intervals
            assert got.get_tier_by_name(name).intervals == want.get_tier_by_name(name).intervals


def raw_corpus(root, dataset):
    """A raw LJSpeech or AISHELL3 layout of three utterances."""
    if dataset == "LJSpeech":
        os.makedirs(os.path.join(root, "wavs"))
        with open(os.path.join(root, "metadata.csv"), "w") as f:
            for i, text in enumerate(["Printing, Mr. Smith said 2 times.", "Dr. Who?",
                                      "in 1884 the bank"]):
                save_wav(os.path.join(root, "wavs", f"LJ001-000{i}.wav"), tone(0.2, i), 24000)
                f.write(f"LJ001-000{i}|x|{text}\n")
            f.write("LJ001-0009|x|no such wav\n")
    else:
        with_wav = os.path.join(root, "train", "wav")
        lines = []
        for i, spk in enumerate(["SSB0005", "SSB0005", "SSB0012"]):
            os.makedirs(os.path.join(with_wav, spk), exist_ok=True)
            name = f"{spk}000{i}.wav"
            save_wav(os.path.join(with_wav, spk, name), tone(0.2, i), 44100)
            lines.append(f"{name}\t你 ni3 好 hao3 吗 ma5\n")
        lines.append("SSB99990001.wav\t缺 que1\n")
        with open(os.path.join(root, "train", "content.txt"), "w", encoding="utf-8") as f:
            f.writelines(lines)


@pytest.mark.parametrize("dataset", ["LJSpeech", "AISHELL3"])
def test_prepare_align_equals_jax(dataset, tmp_path, monkeypatch):
    """The port's CLI and the JAX package's `prepare_align` on the same raw
    corpus: the same files, byte-equal .lab, equal int16 wavs."""
    corpus = str(tmp_path / "corpus")
    raw_corpus(corpus, dataset)
    pre = {"dataset": dataset, "path": {"corpus_path": corpus}, "preprocessing": {
        "audio": {"sampling_rate": SR, "max_wav_value": 32768.0},
        "text": {"text_cleaners": ["english_cleaners"]}}}
    jpre = copy.deepcopy(pre)
    jpre["path"]["raw_path"] = str(tmp_path / "jax_raw")
    (jljspeech if dataset == "LJSpeech" else jaishell3).prepare_align(jpre)
    pre["path"]["raw_path"] = str(tmp_path / "port_raw")
    write_configs(str(tmp_path), dataset, pre)
    monkeypatch.chdir(tmp_path)
    cli_prepare_align.cli(["--dataset", dataset], device="cpu")

    files = sorted(os.path.relpath(os.path.join(d, n), jpre["path"]["raw_path"])
                   for d, _, names in os.walk(jpre["path"]["raw_path"]) for n in names)
    assert len(files) == 6
    got_files = sorted(os.path.relpath(os.path.join(d, n), pre["path"]["raw_path"])
                       for d, _, names in os.walk(pre["path"]["raw_path"]) for n in names)
    assert got_files == files
    for rel in files:
        got, want = (os.path.join(p["path"]["raw_path"], rel) for p in (pre, jpre))
        if rel.endswith(".lab"):
            with open(got, "rb") as a, open(want, "rb") as b:
                assert a.read() == b.read(), rel
        else:
            from scipy.io import wavfile
            (sr_a, a), (sr_b, b) = wavfile.read(got), wavfile.read(want)
            assert sr_a == sr_b == SR and a.dtype == np.int16
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_preprocessor_equals_jax(preprocessed, kind):
    port_root, jax_root, _ = preprocessed[kind]
    port_out, jax_out = (os.path.join(r, "preprocessed") for r in (port_root, jax_root))
    names = sorted(
        os.path.relpath(os.path.join(d, n), jax_out) for d, _, ns in os.walk(jax_out) for n in ns
        if not n.endswith(".TextGrid"))
    got_names = sorted(
        os.path.relpath(os.path.join(d, n), port_out) for d, _, ns in os.walk(port_out) for n in ns
        if not n.endswith(".TextGrid"))
    assert got_names == names
    npys = [n for n in names if n.endswith(".npy")]
    assert len(npys) >= 6 * (5 if kind == "single" else 6)
    assert any("spker_embed" in n for n in npys) == (kind == "multi")
    for rel in names:
        got, want = os.path.join(port_out, rel), os.path.join(jax_out, rel)
        if rel.endswith(".npy"):
            g, w = np.load(got), np.load(want)
            assert g.dtype == w.dtype and g.shape == w.shape, rel
            rtol = 1e-4 if rel.startswith("spker_embed") else 1e-6
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * 1e-2, err_msg=rel)
        elif rel.endswith((".txt", ".json")):
            with open(got, "rb") as a, open(want, "rb") as b:
                assert a.read() == b.read(), rel
    with open(os.path.join(port_out, "train.txt")) as f:
        assert len(f.read().splitlines()) == (4 if kind == "single" else 5)


def test_deepspeaker_matches_jax():
    """The network on the JAX weights through the bridge against
    `DeepSpeakerResCNN.apply`, and `PreDefinedEmbedder` end to end on a
    wav long enough for `sample_from_mfcc` to draw its window from numpy's
    global RNG, seeded the same."""
    variables = jax_embedder_variables()
    x = np.random.RandomState(0).randn(2, 160, 64, 1).astype(np.float32)
    want = jax.jit(jembedder.DeepSpeakerResCNN().apply)(variables, x)
    module = speaker_embedder.DeepSpeakerResCNN().eval()
    module.load_state_dict(deepspeaker_state_dict(variables["params"], variables["batch_stats"]),
                           strict=True)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert_close(got, np.asarray(want), rtol=1e-4, atol=1e-6, msg="embedding")
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, rtol=1e-5)

    config = EMBEDDER_CONFIG
    wav = tone(2.5)
    np.random.seed(3)
    want = jembedder.PreDefinedEmbedder(config)(wav)
    embedder = speaker_embedder.PreDefinedEmbedder(config, device="cpu")
    load_jax_weights(embedder, variables)
    np.random.seed(3)
    got = embedder(wav)
    assert got.shape == want.shape == (1, 512)
    assert_close(got, np.asarray(want), rtol=1e-4, atol=1e-6, msg="PreDefinedEmbedder")
    mfcc = speaker_embedder.read_mfcc(wav, SR, 256)
    np.testing.assert_array_equal(mfcc, jembedder.read_mfcc(wav, SR, 256))


def test_embedder_weights_and_devices(tmp_path, monkeypatch, capsys):
    """Without a checkpoint the embedder is random (seed 0) and says so;
    with an .h5 file and no h5py it raises, never falling back to random
    weights; without a GPU it raises unless given the CPU, as the CLIs do."""
    config = EMBEDDER_CONFIG
    a = speaker_embedder.PreDefinedEmbedder(config, ckpt_path=str(tmp_path / "none.h5"),
                                            device="cpu")
    assert "random weights" in capsys.readouterr().out
    b = speaker_embedder.PreDefinedEmbedder(config, ckpt_path=str(tmp_path / "none.h5"),
                                            device="cpu")
    for (name, p), q in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(p, q), name
    (tmp_path / "w.h5").write_bytes(b"")
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError):
        speaker_embedder.PreDefinedEmbedder(config, ckpt_path=str(tmp_path / "w.h5"),
                                            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        speaker_embedder.PreDefinedEmbedder(config)
    for cli in (cli_preprocess.cli, cli_prepare_align.cli):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli(["--dataset", "LJSpeech"])


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_dataset_over_port_output_equals_jax(preprocessed, kind):
    """The port's `AcousticDataset` over the port's preprocessed corpus
    gives the batches the JAX dataset gives over JAX's."""
    port_root, jax_root, pre = preprocessed[kind]
    mc = copy.deepcopy(TINY_MODEL_YAML)
    mc["multi_speaker"] = kind == "multi"
    jpre = copy.deepcopy(pre)
    jpre["path"]["preprocessed_path"] = os.path.join(jax_root, "preprocessed")
    with open(os.path.join(pre["path"]["preprocessed_path"], "speakers.json")) as f:
        assert len(json.load(f)) == (1 if kind == "single" else 2)
    kw = dict(sort=True, drop_last=False)
    want = list(JAcousticDataset("train.txt", "naive", jpre, mc, TINY_TRAIN_YAML, **kw).batches(
        group_size=2, shuffle=True, seed=0, epochs=1))
    got = list(AcousticDataset("train.txt", "naive", pre, mc, TINY_TRAIN_YAML, **kw).batches(
        group_size=2, shuffle=True, seed=0, epochs=1))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, list):
                assert g[k] == v, k
            else:
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                tol = 1e-4 if k == "spker_embeds" else 1e-6
                np.testing.assert_allclose(g[k], v, rtol=tol, atol=tol * 1e-2, err_msg=k)
