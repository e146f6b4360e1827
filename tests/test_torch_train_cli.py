"""The port's train CLI (`mixgantts_tpu_torch.cli.train.main`) on the CPU,
at test_cli.py's tiny configs over a corpus preprocessed by the JAX
`Preprocessor`:

- aux mode against the JAX CLI (`mixgantts_tpu.cli.train.main`): the port
  starts from the JAX CLI's initial weights (through convert.py's bridge),
  dropout is off on both sides, and aux mode's one random input to the
  loss, the diffuse trace, takes its noise from a fixed function of its
  shape on both sides (`patch_trace_by_shape`; under jit the JAX side
  traces one program per shape).  The metrics behind every log line agree
  at rtol 1e-4, and so do the log.txt lines (plus the 5e-5 of printing
  to four decimals);
- that run's orbax checkpoints, exported by `python -m mixgantts_tpu.export`,
  restore into the port at total_step_aux (the aux -> shallow handoff) and,
  at another step, raise naming the missing keys;
- steps_per_call 1 and 2 write the same log.txt and checkpoints; strict
  order at k = 3 writes k = 1's log;
- the aux -> shallow handoff end to end: the "finished aux checkpoint"
  refusal, shallow training with sample panels (test_torch_pipeline.py's
  tiny HiFi-GAN) and validation, and synthesis from the shallow checkpoint;
- at one rank, --data_parallel and --tensor_parallel run unsharded,
  --profile_dir writes a trace and --profile_port arms a window over
  HTTP; two ranks (dp2, and tp2) follow the one-process run, rank 0
  alone draws the sample panel, the one-process run's, and their
  checkpoint resumes in one process;
- a run resumed at step 2 loads no array of the batches it replays untrained
  (`AcousticDataset._load` counted) and logs the uninterrupted run's step 4.
"""

import glob
import os
import re
import shutil
import socket
import sys
import types
import urllib.request

import numpy as np
import pytest
import torch

from mixgantts_tpu.cli import common as jcommon
from mixgantts_tpu.cli import train as jtrain
from mixgantts_tpu.export import export_checkpoint_cli
from mixgantts_tpu_torch.checkpoint import restore_checkpoint
from mixgantts_tpu_torch.cli import common as tcommon
from mixgantts_tpu_torch.cli import synthesize as tsyn
from mixgantts_tpu_torch.cli import train as ttrain
from mixgantts_tpu_torch.convert import discriminator_state_dict, generator_state_dict
from mixgantts_tpu_torch.data.dataset import AcousticDataset
from mixgantts_tpu_torch.train import create_train_state
from mixgantts_tpu_torch.utils import profiling
from mixgantts_tpu_torch.utils.logging import LOSS_KEYS
from test_torch_pipeline import vocoders
from torch_parallel_helpers import recording_panels, run_ranks
from torch_port_helpers import numpy_tree
from torch_train_helpers import (
    cli_workspace, jax_dropout_off, jit_generator_init, patch_trace_by_shape, port_dropout_off,
    recording, recording_losses,
)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train_cli"))
    cli_workspace(root)
    cwd = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(cwd)


def cli_args(model, tag, restore_step=0, seed=0, **kw):
    return types.SimpleNamespace(model=model, dataset="TestCorpus", restore_step=restore_step,
                                 path_tag=tag, seed=seed, data_parallel=False, **kw)


def read_log(configs, name="train"):
    with open(os.path.join(configs[2]["path"]["log_path"], name, "log.txt")) as f:
        return f.read()


def log_numbers(text):
    return [[float(x) for x in re.findall(r"-?\d+\.\d+", line)] for line in text.splitlines()]


def run_port(mp, args, configs, G=None, D=None, dropout=True, vocoder=None):
    """`cli.train.main` on the CPU; G and D from the given state_dicts when
    given, dropout off unless `dropout`, `vocoder` for the panels."""
    def build_model(mode, pre, mc, device=None):
        model, stats = tcommon.build_model(mode, pre, mc, device=device)
        if G is not None:
            model.load_state_dict(G, strict=True)
        if not dropout:
            port_dropout_off(model)
        return model, stats

    def build_discriminator(pre, mc, device=None):
        disc = tcommon.build_discriminator(pre, mc, device=device)
        if D is not None:
            disc.load_state_dict(D, strict=True)
        return disc

    mp.setattr(ttrain, "build_model", build_model)
    mp.setattr(ttrain, "build_discriminator", build_discriminator)
    mp.setattr(ttrain, "get_vocoder", lambda *a, **k: vocoder)
    ttrain.main(args, configs, device="cpu")


def parity_configs(load_configs, args):
    """The configs at the shipped Noam warm-up (2000 steps, as
    configs/LJSpeech/train.yaml): the tiny config's 4 gives learning rates
    of 0.02-0.09 in the first steps, where Adam's first updates, ~lr *
    sign(g), turn rounding-level gradient differences into loss
    differences of ~1e-3 by step 4."""
    configs = load_configs(args)
    configs[2]["optimizer_fs2"]["warm_up_step"] = 2000
    return configs


@pytest.fixture(scope="module")
def jax_aux(workspace):
    """The JAX CLI's aux run from 0 to total_step_aux (path tag "jax"),
    dropout off, the trace noise a function of its shape, its generator
    init jitted: the initial G and D as the port's state_dicts, and the
    metrics of each log line."""
    states, logged = [], []
    with pytest.MonkeyPatch.context() as mp:
        jax_dropout_off(mp)
        patch_trace_by_shape(mp)
        jit_generator_init(mp)
        mp.setattr(jtrain, "get_vocoder", lambda *a, **k: None)
        mp.setattr(jtrain, "create_train_state", recording(jtrain.create_train_state, states))
        mp.setattr(jtrain, "loss_message", recording_losses(jtrain.loss_message, logged))
        args = cli_args("aux", "jax")
        configs = parity_configs(jcommon.load_configs, args)
        jtrain.main(args, configs)
    state = states[0]
    return {"G": generator_state_dict(numpy_tree(state.g_params),
                                      numpy_tree(state.g_batch_stats)),
            "D": discriminator_state_dict(numpy_tree(state.d_params)),
            "logged": logged, "log": read_log(configs)}


def test_aux_log_matches_the_jax_cli(jax_aux, monkeypatch):
    logged = []
    patch_trace_by_shape(monkeypatch)
    monkeypatch.setattr(ttrain, "loss_message", recording_losses(ttrain.loss_message, logged))
    args = cli_args("aux", "port")
    configs = parity_configs(tcommon.load_configs, args)
    run_port(monkeypatch, args, configs, jax_aux["G"], jax_aux["D"], dropout=False)

    total = configs[2]["step"]["total_step_aux"]
    assert [s for s, _ in logged] == [s for s, _ in jax_aux["logged"]] == list(
        range(configs[2]["step"]["log_step"], total + 1, configs[2]["step"]["log_step"]))
    for (s, got), (_, want) in zip(logged, jax_aux["logged"]):
        np.testing.assert_allclose([got[k] for k in LOSS_KEYS], [want[k] for k in LOSS_KEYS],
                                   rtol=1e-4, atol=1e-6, err_msg=f"step {s}")
    text, want_text = read_log(configs), jax_aux["log"]
    assert [line.split(",")[0] for line in text.splitlines()] == [
        line.split(",")[0] for line in want_text.splitlines()]
    for got, want in zip(log_numbers(text), log_numbers(want_text)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)
    ckpt_dir = configs[2]["path"]["ckpt_path"]
    assert sorted(os.listdir(ckpt_dir)) == ["2.pth.tar", "4.pth.tar", "latest"]


def test_jax_export_restores_at_the_handoff(jax_aux, monkeypatch):
    """The JAX CLI's orbax checkpoint at total_step_aux, exported by
    `python -m mixgantts_tpu.export` into the port's checkpoint directory:
    it restores there (G and D as exported, the epoch carried) and shallow
    training goes on from it; restored at another step, where the port
    resumes and needs the optimizer keys, it raises naming them."""
    args = cli_args("shallow", "exp", restore_step=4)
    configs = tcommon.load_configs(args)
    ckpt_dir = configs[2]["path"]["ckpt_path"]
    os.makedirs(ckpt_dir)
    jit_generator_init(monkeypatch)
    monkeypatch.setattr(sys, "argv", [
        "export", "--restore_step", "4", "--model", "aux", "--dataset", "TestCorpus",
        "--path_tag", "jax", "--out", os.path.join(ckpt_dir, "4.pth.tar")])
    export_checkpoint_cli()
    exported = torch.load(os.path.join(ckpt_dir, "4.pth.tar"), weights_only=True)
    assert set(exported) == {"epoch", "G", "D"} and exported["epoch"] >= 2

    pre, mc, tc = configs
    G, _ = tcommon.build_model("shallow", pre, mc, device="cpu")
    D = tcommon.build_discriminator(pre, mc, device="cpu")
    state = create_train_state(G, D, tc, mc, restore_step=4)
    assert restore_checkpoint(ckpt_dir, state, 4, reset_optimizers=True) == 4
    for module, part in ((G, "G"), (D, "D")):
        for k, v in module.state_dict().items():
            assert torch.equal(v, exported[part][k].reshape(v.shape)), k
    assert state.epoch == exported["epoch"] and state.step == 4

    configs[2]["step"]["total_step_shallow"] = 6
    run_port(monkeypatch, args, configs)
    assert torch.load(os.path.join(ckpt_dir, "6.pth.tar"), weights_only=True)["step"] == 6
    shutil.copy(os.path.join(ckpt_dir, "4.pth.tar"), os.path.join(ckpt_dir, "5.pth.tar"))
    args = cli_args("shallow", "exp", restore_step=5)
    with pytest.raises(ValueError, match=r"lacks the keys \['step', 'optG_fs2'"):
        run_port(monkeypatch, args, tcommon.load_configs(args))


def test_steps_per_call_1_and_2_write_the_same_log(workspace, monkeypatch):
    logs, finals = {}, {}
    for k in (1, 2):
        args = cli_args("naive", f"k{k}", steps_per_call=k)
        configs = tcommon.load_configs(args)
        run_port(monkeypatch, args, configs)
        logs[k] = read_log(configs)
        finals[k] = torch.load(os.path.join(configs[2]["path"]["ckpt_path"], "4.pth.tar"),
                               weights_only=True)
        assert os.path.isfile(os.path.join(configs[2]["path"]["ckpt_path"], "2.pth.tar"))
    assert logs[1] == logs[2] and len(logs[1].splitlines()) == 2
    for part in ("G", "D"):
        for name, v in finals[1][part].items():
            assert torch.equal(v, finals[2][part][name]), name
    assert finals[1]["optG"]["param_groups"][0]["count"] == 4


def test_strict_order_matches_k1(workspace, monkeypatch):
    logs = {}
    for tag, k, strict in (("sok1", 1, False), ("sok3", 3, True)):
        args = cli_args("naive", tag, seed=1, steps_per_call=k)
        configs = tcommon.load_configs(args)
        configs[1].setdefault("tpu", {})["strict_batch_order"] = strict
        run_port(monkeypatch, args, configs)
        logs[tag] = read_log(configs)
    assert logs["sok1"] == logs["sok3"] and logs["sok1"]


def test_aux_to_shallow_handoff(workspace, monkeypatch):
    """aux 0 -> 4 with panels, the refusal below total_step_aux, shallow
    4 -> 6 with panels and validation, then synthesis from step 6."""
    _, vocoder = vocoders()
    args = cli_args("aux", "ho")
    configs = tcommon.load_configs(args)
    configs[2]["step"].update(synth_step=4, val_step=4)
    run_port(monkeypatch, args, configs, vocoder=vocoder)
    ckpt_dir = configs[2]["path"]["ckpt_path"]
    assert ckpt_dir.endswith("_shallow_ho")   # aux and shallow share the directory
    # the true epoch, as the reference's aux checkpoints: 2 batches an epoch here
    assert torch.load(os.path.join(ckpt_dir, "4.pth.tar"), weights_only=True)["epoch"] >= 2
    assert len(read_log(configs, "val").splitlines()) == 1

    with pytest.raises(AssertionError, match="finished aux checkpoint"):
        tcommon.load_configs(cli_args("shallow", "ho", restore_step=2))
    args = cli_args("shallow", "ho", restore_step=4)
    configs = tcommon.load_configs(args)
    configs[2]["step"].update(total_step_shallow=6, synth_step=2, val_step=2)
    run_port(monkeypatch, args, configs, vocoder=vocoder)
    ckpt = torch.load(os.path.join(ckpt_dir, "6.pth.tar"), weights_only=True)
    assert ckpt["step"] == 6 and ckpt["stream_start"] == 4
    assert ckpt["optG"]["param_groups"][0]["count"] == 2   # fresh at the handoff
    assert [line.split(",")[0] for line in read_log(configs, "val").splitlines()] == [
        "Step 4/4", "Step 6/6"]

    monkeypatch.setattr(tsyn, "get_vocoder", lambda *a, **k: vocoder)
    (path, mel_len), = tsyn.cli(["--restore_step", "6", "--model", "shallow", "--mode", "single",
                                 "--text", "hello world", "--dataset", "TestCorpus",
                                 "--path_tag", "ho"], device="cpu")
    assert os.path.isfile(path) and mel_len > 0


@pytest.fixture(scope="module")
def plain_naive(workspace):
    """A one-process naive run 0 -> 4 (path tag "plain") with a panel and
    validation at step 4: its configs, its train and val logs, and its
    panels (`recording_panels`)."""
    _, vocoder = vocoders()
    args = cli_args("naive", "plain")
    configs = panel_configs(tcommon.load_configs(args))
    panels = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "synth_one_sample", recording_panels(ttrain, panels))
        run_port(mp, args, configs, vocoder=vocoder)
    return configs, read_log(configs), read_log(configs, "val"), panels


def panel_configs(configs):
    configs[2]["step"].update(synth_step=4, val_step=4)
    return configs


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def close_logs(got, want):
    """Log lines of two runs: the same steps, every number within rtol 1e-4
    plus the 5e-5 of printing to four decimals."""
    assert [line.split(",")[0] for line in got.splitlines()] == \
        [line.split(",")[0] for line in want.splitlines()]
    for a, b in zip(log_numbers(got), log_numbers(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("option", ["data_parallel", "tensor_parallel", "profile_dir",
                                    "profile_port"])
def test_parallel_and_profiling_options_at_one_rank(workspace, monkeypatch, tmp_path,
                                                     plain_naive, option):
    """With one rank --data_parallel and --tensor_parallel 2 run unsharded
    (the plain run's logs, exactly); --profile_dir traces the steady-state
    window; --profile_port serves captures: a request before the first step
    arms a window of 2 steps into the directory it names."""
    armed = str(tmp_path / "armed")
    value = {"data_parallel": True, "tensor_parallel": 2, "profile_dir": str(tmp_path / "trace"),
             "profile_port": free_port()}[option]
    if option == "profile_port":
        def arming(port, profiler, default_dir):
            server = profiling.start_server(port, profiler, default_dir)
            direct = urllib.request.build_opener(urllib.request.ProxyHandler({}))
            with direct.open(f"http://localhost:{port}/?steps=2&dir={armed}") as r:
                assert r.status == 200
            return server

        monkeypatch.setattr(ttrain, "start_server", arming)
    args = cli_args("naive", f"opt_{option}")
    setattr(args, option, value)
    configs = panel_configs(tcommon.load_configs(args))
    run_port(monkeypatch, args, configs, vocoder=vocoders()[1])
    assert read_log(configs) == plain_naive[1] and read_log(configs, "val") == plain_naive[2]
    trace_dir = {"profile_dir": value, "profile_port": armed}.get(option)
    if trace_dir:
        assert glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))


PANEL_RTOL, PANEL_ATOL, PANEL_WAV_ATOL = 1e-4, 1e-4, 2   # the log bar; int16 within 2


@pytest.mark.parametrize("flags,world", [({"data_parallel": True}, 2),
                                         ({"data_parallel": True, "tensor_parallel": 2}, 2)],
                         ids=["dp2", "tp2"])
def test_multi_rank_run_follows_one_process(workspace, tmp_path, plain_naive, flags, world):
    """Two ranks of the train CLI (gloo on the CPU, as torchrun starts them,
    dropout on): rank 0's train and validation logs are the one-process
    run's (`close_logs`); rank 0 alone draws the step-4 sample panels (the
    training panel and validation's), on the full weights (tp2: gathered),
    and their inference traces are the one-process panels' at the logs'
    rtol 1e-4 (atol 1e-4), their wavs within 2 int16 steps (the sharded
    serving bar); the run's step-2 checkpoint resumes in one process to the
    one-process run's step-4 line."""
    tag = "_".join(sorted(flags)) + str(world)
    args = dict(vars(cli_args("naive", tag)), **flags)
    configs = panel_configs(tcommon.load_configs(types.SimpleNamespace(**args)))
    ranks = run_ranks(tmp_path, "train_cli", world, dict(
        root=workspace, args=args, configs=configs, vocoder=vocoders()[1]))
    close_logs(ranks[0]["train"], plain_naive[1])
    close_logs(ranks[0]["val"], plain_naive[2])
    assert [len(r["panels"]) for r in ranks] == [len(plain_naive[3])] + [0] * (world - 1)
    for got, want in zip(ranks[0]["panels"], plain_naive[3]):
        np.testing.assert_allclose(got["trace"], want["trace"], rtol=PANEL_RTOL, atol=PANEL_ATOL)
        np.testing.assert_allclose(got["wav"].astype(np.int32), want["wav"].astype(np.int32),
                                   rtol=0, atol=PANEL_WAV_ATOL)

    resume = cli_args("naive", tag + "_resumed", restore_step=2)
    resumed = panel_configs(tcommon.load_configs(resume))
    shutil.copytree(configs[2]["path"]["ckpt_path"], resumed[2]["path"]["ckpt_path"])
    with pytest.MonkeyPatch.context() as mp:
        run_port(mp, resume, resumed, vocoder=vocoders()[1])
    close_logs(read_log(resumed), plain_naive[1].splitlines()[-1] + "\n")


@pytest.mark.parametrize("k", [1, 2])
def test_resume_loads_no_array_of_the_replayed_batches(workspace, plain_naive, monkeypatch, k):
    """`plain_naive`'s step-2 checkpoint resumed with steps_per_call k: the
    stream's first three batches (the untrained first one and those of
    steps 1 and 2) come from the `.npy` headers alone, so every array the
    run loads up to its last step belongs to a batch it trains on, each
    loaded before its step; the step-4 line is the uninterrupted run's.
    The stream is read without the prefetch thread here, so that loads and
    steps fall in one order."""
    events = []
    load = AcousticDataset._load
    monkeypatch.setattr(AcousticDataset, "_load",
                        staticmethod(lambda path: events.append("load") or load(path)))
    chunk = ttrain.chunk_train_step

    def counted_chunk(step_fn):
        chunk_fn = chunk(step_fn)

        def run(state, batches):
            events.append(len(batches["mel_lens"]))   # a segment of this many steps
            return chunk_fn(state, batches)
        return run

    monkeypatch.setattr(ttrain, "chunk_train_step", counted_chunk)
    monkeypatch.setattr(ttrain, "prefetch", lambda stream: stream)
    args = cli_args("naive", f"resumed_k{k}", restore_step=2, steps_per_call=k)
    configs = panel_configs(tcommon.load_configs(args))
    shutil.copytree(plain_naive[0][2]["path"]["ckpt_path"], configs[2]["path"]["ckpt_path"])
    run_port(monkeypatch, args, configs, vocoder=vocoders()[1])

    per_batch = 6 * configs[2]["optimizer"]["batch_size"]   # six .npy files an utterance
    segments = [i for i, e in enumerate(events) if e != "load"]
    assert sum(events[i] for i in segments) == 2
    start = 0
    for i in segments:   # each segment's batches loaded just before it
        assert events[start:i] == ["load"] * per_batch * events[i], events
        start = i + 1
    close_logs(read_log(configs), plain_naive[1].splitlines()[-1] + "\n")
