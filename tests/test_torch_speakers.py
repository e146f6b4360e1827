"""Multi-speaker synthesis in the port against the JAX package, on the CPU.

- The denoiser with a speaker embedding (its speaker term in the
  conditioner projection of the residual stack's plain version) against the
  flax `Denoiser(multi_speaker=True)`: fp32 at rtol/atol 1e-4
  (test_torch_models.py's bar); with bf16 parameters and activations against
  flax on the same bf16 parameters at mean |diff| < 2% of max|want| (the
  JAX package's bar for its bf16 denoiser, tests/test_pallas.py).
- The whole generator with a speaker table and with an external embedding
  (`spker_embeds`), naive and shallow, injected noise: mel mean |diff| <
  1e-3 and allclose at 1e-3, lengths equal (test_torch_models.py's bars).
- The weight bridge both ways, and `load_reference_generator` on a
  reference checkpoint with speaker keys, strict.
- `TextOnlyDataset` and the CLI's `build_single_batch` read the speaker's
  `spker_embed/*.npy` into the same batches as the JAX classes.
- The synthesis CLI from Chinese text on a tiny AISHELL3-like
  configuration (multi-speaker, DeepSpeaker embeddings, `--speaker_id`):
  the wav it writes equals the port's pipeline fed with the JAX frontend's
  ids and embedding.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from mixgantts_tpu import convert as jconvert
from mixgantts_tpu import frontend as jfront
from mixgantts_tpu.cli import common as jcommon
from mixgantts_tpu.cli.synthesize import build_single_batch as j_build_single_batch
from mixgantts_tpu.data.dataset import TextOnlyDataset as JTextOnlyDataset
from mixgantts_tpu.export import export_generator
from mixgantts_tpu.models.denoiser import Denoiser as JDenoiser
from mixgantts_tpu.pipeline import cast_floats
from mixgantts_tpu.text import sequence_to_text
from mixgantts_tpu_torch import convert as tconvert
from mixgantts_tpu_torch.cli import synthesize as tsyn
from mixgantts_tpu_torch.cli.common import build_model, restore_generator, route_paths
from mixgantts_tpu_torch.data.dataset import TextOnlyDataset
from mixgantts_tpu_torch.models.denoiser import Denoiser
from mixgantts_tpu_torch.pipeline import TTSPipeline, cast_parameters
from test_cli import TINY_MODEL_YAML, TINY_TRAIN_YAML
from test_data_pipeline import PREPROCESS_CONFIG
from test_torch_pipeline import HOP, vocoders
from torch_port_helpers import (
    assert_close, init_jax_generator, jax_multispeaker_generator, numpy_tree,
    speaker_batch, t, text_batch, torch_generator_like,
)

EMBEDDERS = ["none", "DeepSpeaker"]


def strip(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def denoiser_pair(dtype):
    """A flax multi-speaker denoiser's output on numpy inputs, and the
    port's denoiser with the same weights; bf16: the parameters cast (the
    pipeline's `cast_floats`, `cast_parameters`) and the inputs too."""
    B, T, M, Hc, C, L = 2, 23, 20, 24, 16, 3
    r = np.random.RandomState(0)
    x_t = r.randn(B, T, M).astype(np.float32)
    steps = np.array([0, 3])
    cond = r.randn(B, T, Hc).astype(np.float32)
    spk = r.randn(B, Hc).astype(np.float32)
    jden = JDenoiser(n_mels=M, d_encoder=Hc, residual_channels=C, residual_layers=L,
                     multi_speaker=True, fused=False)
    params = numpy_tree(jax.jit(jden.init)(jax.random.PRNGKey(0), x_t, steps, cond, spk)["params"])
    assert "speaker_projection" in params["res_0"]
    out = params["output_projection"]["conv"]
    out["kernel"] = (r.randn(*out["kernel"].shape) * 0.1).astype(np.float32)
    sd = {}
    tconvert._denoiser(params, sd)
    port = Denoiser(n_mels=M, d_encoder=Hc, residual_channels=C, residual_layers=L,
                    multi_speaker=True)
    port.load_state_dict(strip(sd, "diffusion.denoise_fn."), strict=True)
    inputs = (x_t, steps, cond, spk)
    if dtype == "bfloat16":
        params = cast_floats(params, jax.numpy.bfloat16)
        inputs = cast_floats(inputs, jax.numpy.bfloat16)
        port = cast_parameters(port, torch.bfloat16)
    want = np.asarray(jax.jit(jden.apply)({"params": params}, *inputs), np.float32)
    got_inputs = [t(np.asarray(a, np.float32)) for a in inputs]
    got_inputs[1] = got_inputs[1].long()
    return port, got_inputs, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoiser_with_speaker_matches_flax(dtype):
    port, (x_t, steps, cond, spk), want = denoiser_pair(dtype)
    low = dtype == "bfloat16"
    if low:
        x_t, cond, spk = x_t.bfloat16(), cond.bfloat16(), spk.bfloat16()
    with torch.no_grad():
        got = port(x_t, steps, cond, spk)
        without = port(x_t, steps, cond)
    assert got.dtype == (torch.bfloat16 if low else torch.float32)
    got = got.float()
    if low:
        err = (got.numpy() - want).__abs__().mean() / np.abs(want).max()
        assert err < 0.02, f"bf16 denoiser mean|diff| {err:.3g} of max|want|"
    else:
        assert_close(got, want, rtol=1e-4, atol=1e-4)
    # the speaker term moves the output: it reaches the stack
    assert (got - without.float()).abs().max() > 1e-2


def run_generator(mode, embedder, T=128):
    model, variables, apply = jax_multispeaker_generator(mode, embedder)
    batch = speaker_batch(text_batch(B=2, P=10, W=4, seed=1), embedder, seed=3)
    r = np.random.RandomState(0)
    ov = {"start_noise": r.randn(2, T, model.n_mels).astype(np.float32),
          "step_noises": r.randn(model.schedule.num_timesteps, 2, T,
                                 model.n_mels).astype(np.float32)}
    want = apply(
        variables, speakers=batch["speakers"], texts=batch["texts"],
        src_lens=batch["src_lens"], word_boundaries=batch["word_boundaries"],
        src_w_lens=batch["src_w_lens"], spker_embeds=batch.get("spker_embeds"),
        max_mel_len=T, train=False, noise_override=ov,
        rngs={"diffusion": jax.random.PRNGKey(0)})
    port = torch_generator_like(model, variables)
    spk = batch.get("spker_embeds")
    with torch.no_grad():
        got = port(t(batch["speakers"]), t(batch["texts"]), t(batch["src_lens"]),
                   t(batch["word_boundaries"]), t(batch["src_w_lens"]), T,
                   noise_override={k: t(v) for k, v in ov.items()},
                   spker_embeds=None if spk is None else t(spk))
    return port, batch, got, want


@pytest.mark.parametrize("embedder", EMBEDDERS)
@pytest.mark.parametrize("mode", ["naive", "shallow"])
def test_multispeaker_generator_matches_flax(mode, embedder):
    port, batch, got, want = run_generator(mode, embedder)
    assert isinstance(port.speaker_emb, torch.nn.Embedding if embedder == "none"
                      else torch.nn.Linear)
    np.testing.assert_array_equal(got.mel_lens.numpy(), np.asarray(want.mel_lens))
    assert int(got.mel_lens.min()) > 0
    a, b = got.mel_pred.numpy(), np.asarray(want.mel_pred)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).mean() < 1e-3
    assert_close(a, b, rtol=1e-3, atol=1e-3)
    # another speaker gives another mel
    other = dict(batch, speakers=(batch["speakers"] + 1) % 3)
    if embedder != "none":
        other["spker_embeds"] = batch["spker_embeds"][::-1].copy()
    spk = other.get("spker_embeds")
    with torch.no_grad():
        moved = port(t(other["speakers"]), t(batch["texts"]), t(batch["src_lens"]),
                     t(batch["word_boundaries"]), t(batch["src_w_lens"]), a.shape[1],
                     noise_override={"start_noise": torch.zeros(a.shape),
                                     "step_noises": torch.zeros((port.diffusion.num_timesteps,) + a.shape)},
                     spker_embeds=None if spk is None else t(spk))
    assert np.abs(moved.mel_pred.numpy() - a).max() > 1e-3
    if embedder != "none":
        with pytest.raises(ValueError, match="spker_embeds"):
            port.speaker_embedding(t(batch["speakers"]))


@pytest.mark.parametrize("embedder", EMBEDDERS)
def test_multispeaker_bridge_round_trip_and_reference_load(embedder):
    """JAX trees -> the port's state_dict -> `mixgantts_tpu.convert`'s
    reader gives back the same trees, bit for bit; a reference checkpoint
    (`mixgantts_tpu.export`) with the speaker keys loads strictly into the
    port and equals the bridge's tensors."""
    model, variables, _ = jax_multispeaker_generator("shallow", embedder)
    sd = tconvert.generator_state_dict(variables["params"], variables["batch_stats"])
    assert ("speaker_emb.bias" in sd) == (embedder != "none")
    assert "diffusion.denoise_fn.residual_layers.1.speaker_projection.linear.weight" in sd
    params, stats = jconvert.convert_generator(
        {k: v.numpy() for k, v in sd.items()}, "shallow",
        encoder_layers=model.encoder_layers, decoder_layers=model.decoder_layers,
        denoiser_layers=model.residual_layers, multi_speaker=True)
    for got_tree, want_tree in zip((params, stats), (variables["params"], variables["batch_stats"])):
        assert jax.tree_util.tree_structure(got_tree) == jax.tree_util.tree_structure(want_tree)
        for g, w in zip(jax.tree_util.tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)):
            np.testing.assert_array_equal(g, w)
    G = export_generator(variables["params"], variables["batch_stats"],
                         betas=model.schedule.betas, spec_min=np.asarray(model.schedule.spec_min),
                         spec_max=np.asarray(model.schedule.spec_max))
    port = torch_generator_like(model, variables)
    with torch.no_grad():
        for p in port.parameters():
            p.zero_()
    tconvert.load_reference_generator(port, {k: torch.from_numpy(np.array(v)) for k, v in G.items()})
    got = port.state_dict()
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
    with pytest.raises(RuntimeError, match="Missing key"):
        tconvert.load_reference_generator(port, {k: torch.from_numpy(np.array(v))
                                                 for k, v in G.items() if k != "speaker_emb.weight"})


def corpus_configs(root, embedder="DeepSpeaker", language="zh"):
    """A tiny AISHELL3-like configuration: multi-speaker, Mandarin, the
    given speaker embedder (12-wide embeddings), the tiny vocoder's hop."""
    pre = copy.deepcopy(PREPROCESS_CONFIG)
    pp = pre["preprocessing"]
    pp["speaker_embedder"] = embedder
    pp["text"] = {"text_cleaners": [], "language": language,
                  "sub_divide_word": True, "max_phoneme_num": 7}
    pp["stft"]["hop_length"] = HOP
    pre["path"] = {"lexicon_path": os.path.join(root, "pinyin-lexicon.txt"),
                   "preprocessed_path": os.path.join(root, "preprocessed")}
    mc = copy.deepcopy(TINY_MODEL_YAML)
    mc["multi_speaker"] = True
    mc["external_speaker_dim"] = 12
    train = copy.deepcopy(TINY_TRAIN_YAML)
    train["path"] = {k: os.path.join(root, "output", k[:-5], "ZhSpeakers")
                     for k in ("ckpt_path", "log_path", "result_path")}
    return pre, mc, train


SPEAKERS = {"7": 0, "12": 1, "31": 2}
SOURCE = ["你好", "你好你好", "好"]


@pytest.fixture(scope="module")
def zh_workspace(tmp_path_factory):
    """config/ZhSpeakers/*.yaml, a pinyin lexicon, speakers.json, one
    spker_embed .npy per speaker, phones per word of a 3-line source file,
    and a naive-mode reference checkpoint made on the JAX side; the working
    directory is the workspace while the tests run."""
    root = str(tmp_path_factory.mktemp("torch_zh_ws"))
    pre, mc, train = corpus_configs(root)
    cfg_dir = os.path.join(root, "config", "ZhSpeakers")
    os.makedirs(cfg_dir)
    for name, cfg in (("preprocess.yaml", pre), ("model.yaml", mc), ("train.yaml", train)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.dump(cfg, f)
    with open(pre["path"]["lexicon_path"], "w") as f:
        f.write("ni3 n i3\nhao3 h ao3\n")
    pp = pre["path"]["preprocessed_path"]
    os.makedirs(os.path.join(pp, "phones_per_word"))
    os.makedirs(os.path.join(pp, "spker_embed"))
    with open(os.path.join(pp, "speakers.json"), "w") as f:
        json.dump(SPEAKERS, f)
    r = np.random.RandomState(11)
    for name in SPEAKERS:
        np.save(os.path.join(pp, "spker_embed", f"{name}-spker_embed.npy"),
                r.randn(1, 12).astype(np.float32))
    lines = []
    for i, raw in enumerate(SOURCE):
        seq, wb = jfront.preprocess_mandarin(raw, pre, verbose=False)
        speaker = list(SPEAKERS)[i]
        np.save(os.path.join(pp, "phones_per_word", f"{speaker}-phones_per_word-utt{i}.npy"), wb)
        lines.append(f"utt{i}|{speaker}|{sequence_to_text(seq.tolist())}|{raw}")
    with open(os.path.join(root, "source.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    model, stats = jcommon.build_model("naive", pre, mc)
    assert model.n_speakers == len(SPEAKERS) and model.embedder_type == "DeepSpeaker"
    batch = dict(text_batch(), spker_embeds=np.zeros((2, 12), np.float32))
    variables = init_jax_generator(model, batch, 32, seed=4)
    keep = mc["denoiser"]["keep_bins"]
    G = export_generator(variables["params"], variables.get("batch_stats", {}),
                         betas=model.schedule.betas,
                         spec_min=np.asarray(stats.spec_min[:keep]),
                         spec_max=np.asarray(stats.spec_max[:keep]),
                         model_config=mc, stats=stats)
    ckpt_dir = jcommon.route_paths(copy.deepcopy(train), "naive")["path"]["ckpt_path"]
    os.makedirs(ckpt_dir)
    torch.save({"G": {k: torch.from_numpy(np.array(v)) for k, v in G.items()}},
               os.path.join(ckpt_dir, "4.pth.tar"))
    cwd = os.getcwd()
    os.chdir(root)
    yield {"root": root, "pre": pre, "mc": mc, "train": train}
    os.chdir(cwd)


def assert_same_batch(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], list):
            assert got[key] == want[key], key
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_text_only_dataset_loads_speaker_embeddings(zh_workspace):
    pre, mc = zh_workspace["pre"], zh_workspace["mc"]
    got = list(TextOnlyDataset("source.txt", pre, mc).batches(2))
    want = list(JTextOnlyDataset("source.txt", pre, mc).batches(2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["spker_embeds"].shape == (len(g["ids"]), 12)
        assert_same_batch(g, w)
    # a table model reads no embedding
    table = dict(pre, preprocessing=dict(pre["preprocessing"], speaker_embedder="none"))
    assert "spker_embeds" not in next(TextOnlyDataset("source.txt", table, mc).batches(8))


def test_build_single_batch_loads_the_speakers_embedding(zh_workspace):
    pre, mc = zh_workspace["pre"], zh_workspace["mc"]
    args = tsyn.build_argparser().parse_args(
        ["--restore_step", "4", "--model", "naive", "--mode", "single", "--text", "你好",
         "--speaker_id", "12", "--dataset", "ZhSpeakers"])
    got = tsyn.build_single_batch(args, pre, mc)
    assert_same_batch(got, j_build_single_batch(args, pre, mc))
    assert got["speakers"].tolist() == [1] and got["spker_embeds"].shape == (1, 12)


def test_mandarin_multispeaker_cli(zh_workspace, monkeypatch):
    """`--dataset ... --mode single --text <hanzi> --speaker_id N` writes
    the wav of the port's pipeline fed with the JAX frontend's batch (ids,
    speaker index and embedding), on the strictly restored checkpoint; the
    speaker's embedding changes the output."""
    ws = zh_workspace
    _, tvoc = vocoders()
    monkeypatch.setattr(tsyn, "get_vocoder", lambda *args, **kwargs: tvoc)
    argv = ["--restore_step", "4", "--model", "naive", "--mode", "single",
            "--text", "你好你好", "--dataset", "ZhSpeakers"]
    written = {}
    for speaker in ("7", "31"):
        (path, mel_len), = tsyn.cli(argv + ["--speaker_id", speaker], device="cpu")
        sr, wav = wavfile.read(path)
        assert sr == PREPROCESS_CONFIG["preprocessing"]["audio"]["sampling_rate"]
        assert wav.dtype == np.int16 and mel_len > 0 and len(wav) == mel_len * HOP
        written[speaker] = wav
    model, _ = build_model("naive", ws["pre"], ws["mc"], device="cpu")
    restore_generator(model, route_paths(copy.deepcopy(ws["train"]), "naive")["path"]["ckpt_path"], 4)
    args = tsyn.build_argparser().parse_args(argv + ["--speaker_id", "31"])
    batch = j_build_single_batch(args, ws["pre"], ws["mc"])
    batch = {k: v for k, v in batch.items() if k not in ("ids", "raw_texts")}
    (want,), _, _ = TTSPipeline(model, tvoc, ws["pre"], ws["mc"])(batch)
    np.testing.assert_array_equal(written["31"], want)
    n = min(len(written["7"]), len(want))
    assert not np.array_equal(written["7"][:n], want[:n])
