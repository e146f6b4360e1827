"""The port's validation and sample synthesis against the JAX package's, on
the CPU, at test_cli.py's tiny configs over a corpus preprocessed by the JAX
`Preprocessor`, with the same weights on both sides (a jitted JAX init
through convert.py's bridge) and test_torch_pipeline.py's tiny HiFi-GAN:

- `cli.evaluate.evaluate` in aux mode, the diffuse trace's noise a fixed
  function of its shape on both sides, equals JAX's `evaluate` (rtol
  1e-5); in naive mode it is finite and logs its sample panel;
- teacher-forced synthesis (`cli.synthesize --teacher_forced`, aux) matches
  the JAX CLI's `synthesize` within test_torch_cli.py's tolerance (int16
  within 1 LSB, mel mean |diff| < 1e-3);
- the train CLI's `synthesize_sample` in aux mode matches JAX's
  `synth_one_sample` on JAX's output: wavs within 1 LSB, the mel panels'
  mean |diff| < 1e-3, the attention panel within 1e-5;
- `return_trace` (naive, shallow) equals the JAX trace under injected
  `start_noise` and `step_noises` at test_torch_pipeline.py's tolerance
  (mean |diff| < 1e-3).
"""

import copy
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.cli import common as jcommon
from mixgantts_tpu.cli import evaluate as jevaluate
from mixgantts_tpu.cli import synthesize as jsyn
from mixgantts_tpu.data.dataset import AcousticDataset as JAcousticDataset
from mixgantts_tpu.train.state import TrainState as JTrainState
from mixgantts_tpu.utils import synth as jsynth
from mixgantts_tpu_torch.cli import common as tcommon
from mixgantts_tpu_torch.cli import evaluate as tevaluate
from mixgantts_tpu_torch.cli import synthesize as tsyn
from mixgantts_tpu_torch.cli import train as ttrain
from mixgantts_tpu_torch.convert import discriminator_state_dict, generator_state_dict
from mixgantts_tpu_torch.train import create_train_state
from mixgantts_tpu_torch.utils import synth as tsynth
from mixgantts_tpu_torch.utils.logging import LOSS_KEYS
from test_torch_pipeline import vocoders
from torch_port_helpers import init_jax_generator, numpy_tree, text_batch
from torch_train_helpers import cli_workspace, patch_trace_by_shape, recording_losses

STEP = 4


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The workspace, its configs, and per mode the JAX model, its
    variables (one jitted shallow init serves the three modes) and the
    port's G and D with the same weights."""
    root = str(tmp_path_factory.mktemp("torch_eval_synth"))
    cli_workspace(root)
    cwd = os.getcwd()
    os.chdir(root)
    args = types.SimpleNamespace(model="aux", dataset="TestCorpus", restore_step=STEP,
                                 path_tag="")
    pre, mc, tc = jcommon.load_configs(args)
    shallow, _ = jcommon.build_model("shallow", pre, mc)
    variables = init_jax_generator(shallow, text_batch(), 32)
    jdisc = jcommon.build_discriminator(pre, mc)
    x = np.zeros((1, 16, pre["preprocessing"]["mel"]["n_mel_channels"]), np.float32)
    d_params = numpy_tree(jax.jit(jdisc.init)(jax.random.PRNGKey(3), x, x, None,
                                              np.zeros((1,), np.int32))["params"])
    models = {}
    for mode in ("aux", "naive", "shallow"):
        v = variables
        if mode == "naive":
            v = {"params": {k: p for k, p in variables["params"].items()
                            if k not in ("decoder", "mel_linear", "postnet")}}
        G, _ = tcommon.build_model(mode, pre, mc, device="cpu")
        G.load_state_dict(generator_state_dict(v["params"], v.get("batch_stats", {})),
                          strict=True)
        D = tcommon.build_discriminator(pre, mc, device="cpu")
        D.load_state_dict(discriminator_state_dict(d_params), strict=True)
        models[mode] = (jcommon.build_model(mode, pre, mc)[0], v, G, D)
    yield {"configs": (pre, mc, tc), "models": models, "jdisc": jdisc, "d_params": d_params}
    os.chdir(cwd)


def jax_state(ws, mode):
    _, v, _, _ = ws["models"][mode]
    return JTrainState(step=jnp.asarray(STEP, jnp.int32), epoch=jnp.asarray(1, jnp.int32),
                       g_params=v["params"], g_batch_stats=v.get("batch_stats", {}),
                       d_params=ws["d_params"], opt_g_fs2=None, opt_g=None, opt_d=None,
                       lr_g=jnp.asarray(1e-4), lr_d=jnp.asarray(1e-4),
                       rng=jax.random.PRNGKey(0))


def port_state(ws, mode):
    _, _, G, D = ws["models"][mode]
    pre, mc, tc = ws["configs"]
    return create_train_state(G, D, tc, mc, restore_step=STEP)


class RecordingWriter:
    """A SummaryWriter that keeps the tags of what it is given."""

    def __init__(self):
        self.tags = []

    def add_scalar(self, tag, *args, **kwargs):
        self.tags.append(tag)

    add_figure = add_audio = add_scalar


def test_evaluate_matches_jax_in_aux_mode(ws, monkeypatch):
    patch_trace_by_shape(monkeypatch)
    jlogged, tlogged = [], []
    monkeypatch.setattr(jevaluate, "loss_message",
                        recording_losses(jevaluate.loss_message, jlogged))
    monkeypatch.setattr(tevaluate, "loss_message",
                        recording_losses(tevaluate.loss_message, tlogged))
    jmodel, _, G, D = ws["models"]["aux"]
    jmsg = jevaluate.evaluate("aux", jmodel, ws["jdisc"], jax_state(ws, "aux"), ws["configs"])
    tmsg = tevaluate.evaluate("aux", G, D, port_state(ws, "aux"), ws["configs"])
    assert tmsg.split(",")[0] == jmsg.split(",")[0] == f"Step {STEP}/4"
    (_, got), = tlogged
    (_, want), = jlogged
    np.testing.assert_allclose([got[k] for k in LOSS_KEYS], [want[k] for k in LOSS_KEYS],
                               rtol=1e-5, atol=1e-6)


def test_evaluate_naive_is_finite_and_logs_its_panel(ws):
    _, tvoc = vocoders()
    _, _, G, D = ws["models"]["naive"]
    writer = RecordingWriter()
    msg = tevaluate.evaluate("naive", G, D, port_state(ws, "naive"), ws["configs"],
                             logger=writer, vocoder=tvoc)
    values = [float(x) for x in re.findall(r"-?\d+\.\d+|nan|inf", msg.split(", ", 1)[1])]
    assert len(values) == 9 and np.isfinite(values).all()
    assert {f"Loss/{k}" for k in LOSS_KEYS} <= set(writer.tags)
    assert {"Validation", "Validation/reconstructed", "Validation/synthesized"} <= set(
        writer.tags)


def recording_results(write_results, out):
    """`write_results`, keeping each call's (basenames, mels, lengths, wavs)."""
    def wrapped(args, basenames, mel_preds, mel_lens, wavs, *rest):
        out.append((list(basenames), np.asarray(mel_preds), np.asarray(mel_lens), list(wavs)))
        return write_results(args, basenames, mel_preds, mel_lens, wavs, *rest)
    return wrapped


def test_teacher_forced_matches_the_jax_cli(ws, monkeypatch):
    jvoc, tvoc = vocoders()
    pre, mc, tc = ws["configs"]
    jmodel, variables, G, _ = ws["models"]["aux"]
    want, got = [], []
    monkeypatch.setattr(jsynth, "write_results", recording_results(jsynth.write_results, want))
    monkeypatch.setattr(tsynth, "write_results", recording_results(tsynth.write_results, got))

    args = types.SimpleNamespace(model="aux", restore_step=STEP, teacher_forced=True,
                                 mode="batch", speaker_id=0)
    jtc = copy.deepcopy(tc)
    jtc["path"]["result_path"] += "_jax"
    batches = [b for b in JAcousticDataset("val.txt", "aux", pre, mc, tc).batches(
        group_size=1, shuffle=False, epochs=1) if b is not None]
    jsyn.synthesize(jmodel, variables, args, (pre, mc, jtc), jvoc, batches, (1.0, 1.0, 1.0))

    ckpt = tcommon.load_configs(types.SimpleNamespace(
        model="aux", dataset="TestCorpus", restore_step=STEP, path_tag="tf"))[2]["path"]["ckpt_path"]
    os.makedirs(ckpt)
    torch.save({"epoch": 1, "G": G.state_dict()}, os.path.join(ckpt, f"{STEP}.pth.tar"))
    monkeypatch.setattr(tsyn, "get_vocoder", lambda *a, **k: tvoc)
    written = tsyn.cli(["--restore_step", str(STEP), "--model", "aux", "--mode", "batch",
                        "--teacher_forced", "--dataset", "TestCorpus", "--path_tag", "tf"],
                       device="cpu")
    assert [os.path.basename(p) for p, _ in written] == [
        f"{n}_teacher_forced.wav" for b in batches for n in b["ids"]]
    assert len(got) == len(want) == len(batches)
    for (names, mel, lens, wavs), (jnames, jmel, jlens, jwavs) in zip(got, want):
        assert names == jnames
        np.testing.assert_array_equal(lens, jlens)
        assert np.abs(mel - jmel).mean() < 1e-3
        for w, jw in zip(wavs, jwavs):
            assert w.dtype == np.int16 and w.shape == jw.shape
            assert np.abs(w.astype(np.int32) - jw.astype(np.int32)).max() <= 1


def test_synthesize_sample_matches_jax_synth_one_sample(ws, monkeypatch):
    """aux mode: the train CLI's panels of a training batch."""
    jvoc, tvoc = vocoders()
    pre, mc, tc = ws["configs"]
    jmodel, variables, G, _ = ws["models"]["aux"]
    patch_trace_by_shape(monkeypatch)
    panels = {"jax": [], "port": []}
    for side, module in (("jax", jsynth), ("port", tsynth)):
        monkeypatch.setattr(module, "plot_mel",
                            lambda data, titles, out=panels[side]: out.append((data, titles)))
        monkeypatch.setattr(module, "plot_multi_attn",
                            lambda data, out=panels[side]: out.append(data))
    batch = next(b for b in JAcousticDataset("train.txt", "aux", pre, mc, tc).batches(
        group_size=1, shuffle=False, epochs=1) if b is not None)
    kwargs = jcommon.model_batch_of(batch)
    apply = jax.jit(jmodel.apply, static_argnames=("max_mel_len", "train"))
    out = apply(variables, **kwargs, max_mel_len=batch["mels"].shape[1], train=False,
                rngs={"diffusion": jax.random.PRNGKey(STEP)})
    want = jsynth.synth_one_sample("aux", batch, out, None, jvoc, mc, pre, jmodel.schedule)
    got = ttrain.synthesize_sample("aux", G, port_state(ws, "aux"), batch, tvoc, mc, pre)

    assert got[4] == want[4] == batch["ids"][0]
    for w, jw in zip(got[2:4], want[2:4]):
        assert w.dtype == np.int16 and w.shape == jw.shape
        assert np.abs(w.astype(np.int32) - jw.astype(np.int32)).max() <= 1
    (mels, titles), jattn = panels["port"][0], panels["jax"][1]
    (jmels, jtitles), attn = panels["jax"][0], panels["port"][1]
    assert titles == jtitles
    for m, jm in zip(mels, jmels):
        assert m.shape == jm.shape and np.abs(m - np.asarray(jm)).mean() < 1e-3
    np.testing.assert_allclose(attn[0], np.asarray(jattn[0]), atol=1e-5)


@pytest.mark.parametrize("mode", ["shallow", "naive"])
def test_return_trace_matches_jax(ws, mode):
    jmodel, variables, G, _ = ws["models"][mode]
    batch = text_batch(B=2, P=12, W=4, seed=5)
    text = {k: batch[k] for k in ("speakers", "texts", "src_lens", "word_boundaries",
                                  "src_w_lens")}
    T, M = 64, ws["configs"][0]["preprocessing"]["mel"]["n_mel_channels"]
    S = len(jmodel.schedule.betas)
    r = np.random.RandomState(6)
    noise = {"start_noise": r.randn(2, T, M).astype(np.float32),
             "step_noises": r.randn(S, 2, T, M).astype(np.float32)}
    apply = jax.jit(jmodel.apply, static_argnames=("max_mel_len", "train", "return_trace"))
    want = apply(variables, **text, max_mel_len=T, train=False, return_trace=True,
                 noise_override=noise, rngs={"diffusion": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = G(**{k: torch.as_tensor(v) for k, v in text.items()}, max_mel_len=T,
                return_trace=True, noise_override={k: torch.from_numpy(v)
                                                   for k, v in noise.items()})
    assert got.mel_pred.shape == (S + 1, 2, T, M) == np.shape(want.mel_pred)
    np.testing.assert_array_equal(got.mel_lens.numpy(), np.asarray(want.mel_lens))
    assert np.abs(got.mel_pred.numpy() - np.asarray(want.mel_pred)).mean() < 1e-3
