"""The port's training data path, `chunk_train_step` and `.pth.tar`
checkpoints, on the CPU.

Against the JAX package:
- `AcousticDataset` over a corpus built by the JAX `Preprocessor`
  (test_data_pipeline.py's `make_corpus`): on train.txt (sorted, shuffled,
  seed 0, two epochs) and val.txt (unsorted), every field of every batch,
  in order, and every epoch marker equal the JAX dataset's exactly; the
  same for a multi-speaker configuration that carries `spker_embeds`;
- `pad_3d` and `expand` equal JAX's exactly; `prefetch` keeps order and
  epoch markers and re-raises the producer's exception;
- the train CLI's `schedule_segments` yields the same events as
  `mixgantts_tpu.cli.train.schedule_segments` on seeded random streams
  (plain and strict order, k in {1, 2, 3, 8}, several period sets,
  streams with and without epoch markers);
- a resume's replay (`replayed_batches`, `AcousticDataset.batches(
  replayed=)`): the batches it skips come from the `.npy` headers (their
  shapes and types, zero mels), and it trains on the uninterrupted run's
  batches, every field equal, where the scheduler takes batches out of
  arrival order too.

Steps and checkpoints at test_cli.py's tiny configs (the port's own random
init), dropout on (it draws from torch's default generator, which the
checkpoint carries):
- k = 3 chunked steps equal 3 sequential steps bit for bit in the
  parameters, the PostNet statistics, the optimizer state and the metrics
  (aux and naive);
- resume: 2 steps, a checkpoint, a fresh state restored from it and 2 more
  steps equal 4 uninterrupted steps bit for bit (aux and naive);
- the aux -> shallow handoff loads G and D, keeps the optimizers, step and
  learning rates fresh and carries the epoch; a checkpoint of epoch, G and
  D only restores there and, elsewhere, raises naming the missing keys;
- into JAX: the saved G through `mixgantts_tpu.convert.convert_generator`
  gives the port's aux-mode inference in JAX (same injected trace noise),
  the saved D through `convert_discriminator` the port's features (rtol
  1e-5);
- the reference format: `torch.optim.Adam` and `ExponentialLR` load the
  optimizer and scheduler entries.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from mixgantts_tpu.cli import common as jcommon
from mixgantts_tpu.cli import train as jtrain
from mixgantts_tpu.convert import convert_discriminator, convert_generator
from mixgantts_tpu.data.dataset import AcousticDataset as JAcousticDataset
from mixgantts_tpu.data.preprocessor import Preprocessor
from mixgantts_tpu.utils import tools as jtools
from mixgantts_tpu_torch.checkpoint import (
    checkpoint_path, latest_step, restore_checkpoint, save_checkpoint,
)
from mixgantts_tpu_torch.cli import common as tcommon
from mixgantts_tpu_torch.cli import train as ttrain
from mixgantts_tpu_torch.data.dataset import AcousticDataset
from mixgantts_tpu_torch.data.prefetch import prefetch
from mixgantts_tpu_torch.train import chunk_train_step, create_train_state, make_train_step
from mixgantts_tpu_torch.utils import tools
from test_cli import TINY_MODEL_YAML, TINY_TRAIN_YAML
from test_data_pipeline import MODEL_CONFIG, PREPROCESS_CONFIG, make_corpus
from torch_port_helpers import assert_close
from torch_train_helpers import patch_jax_trace, tiny_batch, torch_batch

N_UTTS = 12
SPK_DIM = 8
STEPS = 4          # steps of the chunk and resume tests
PRE = dict(PREPROCESS_CONFIG, path={"preprocessed_path": "/nonexistent"})   # default stats
N_MELS = PRE["preprocessing"]["mel"]["n_mel_channels"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A preprocessed corpus of N_UTTS utterances (three of them in val.txt)
    with a speaker embedding for its one speaker."""
    root = str(tmp_path_factory.mktemp("torch_dataset"))
    make_corpus(root, n_utts=N_UTTS)
    pre = copy.deepcopy(PREPROCESS_CONFIG)
    pre["preprocessing"]["val_size"] = 3
    pre["path"] = {"raw_path": os.path.join(root, "raw_data"),
                   "preprocessed_path": os.path.join(root, "preprocessed"),
                   "corpus_path": root}
    Preprocessor(pre, MODEL_CONFIG, {"optimizer": {"batch_size": 2}}).build_from_path()
    pp = pre["path"]["preprocessed_path"]
    with open(os.path.join(pp, "speakers.json")) as f:
        speakers = json.load(f)
    os.makedirs(os.path.join(pp, "spker_embed"), exist_ok=True)
    r = np.random.RandomState(0)
    for spk in speakers:
        np.save(os.path.join(pp, "spker_embed", f"{spk}-spker_embed.npy"),
                r.randn(1, SPK_DIM).astype(np.float32))
    return pre


def configs(pre, multi_speaker):
    pre = copy.deepcopy(pre)
    mc = copy.deepcopy(TINY_MODEL_YAML)
    if multi_speaker:
        mc["multi_speaker"] = True
        pre["preprocessing"]["speaker_embedder"] = "DeepSpeaker"
    return pre, mc, copy.deepcopy(TINY_TRAIN_YAML)


def assert_streams_equal(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        assert g is not None and g.keys() == w.keys(), i
        for k, v in w.items():
            if isinstance(v, list):
                assert g[k] == v, (i, k)
            else:
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, (i, k)
                np.testing.assert_array_equal(g[k], v, err_msg=f"batch {i} {k}")


@pytest.mark.parametrize("multi_speaker", [False, True])
@pytest.mark.parametrize("mode", ["naive", "shallow"])
def test_train_batches_equal_jax(corpus, mode, multi_speaker):
    """Sorted, shuffled (seed 0) train.txt batches over two epochs."""
    cfg = configs(corpus, multi_speaker)
    kw = dict(sort=True, drop_last=True)
    want = list(JAcousticDataset("train.txt", mode, *cfg, **kw).batches(
        group_size=2, shuffle=True, seed=0, epochs=2))
    got = list(AcousticDataset("train.txt", mode, *cfg, **kw).batches(
        group_size=2, shuffle=True, seed=0, epochs=2))
    assert_streams_equal(got, want)
    assert sum(b is None for b in got) == 2
    assert len({b["mels"].shape for b in got if b is not None}) > 1, "one mel bucket only"
    assert ("spker_embeds" in got[0]) == multi_speaker


@pytest.mark.parametrize("multi_speaker", [False, True])
def test_val_batches_equal_jax(corpus, multi_speaker):
    """Unsorted val.txt batches, one epoch, and the whole-corpus group
    shrink (fewer utterances than one draw)."""
    cfg = configs(corpus, multi_speaker)
    for group_size in (1, 4):
        want = list(JAcousticDataset("val.txt", "naive", *cfg).batches(
            group_size=group_size, shuffle=False, epochs=1))
        got = list(AcousticDataset("val.txt", "naive", *cfg).batches(
            group_size=group_size, shuffle=False, epochs=1))
        assert_streams_equal(got, want)


def test_pad_3d_and_expand_equal_jax():
    r = np.random.RandomState(0)
    boxes = [r.rand(3, 5), r.rand(1, 2), r.rand(4, 4)]
    got, want = tools.pad_3d(boxes, 3, 6, 7), jtools.pad_3d(boxes, 3, 6, 7)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    values, durations = r.rand(6), np.array([2, 0, 3, -1, 1, 4])
    np.testing.assert_array_equal(tools.expand(values, durations),
                                  jtools.expand(values, durations))


def test_prefetch_keeps_order_and_markers_and_reraises():
    items = [1, None, 2, 3, None, 4]
    assert list(prefetch(iter(items), size=1)) == items

    def failing():
        yield 1
        yield None
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in prefetch(failing()):
            got.append(item)
    assert got == [1, None]


def random_stream(seed, n, epoch_markers):
    """n fake batches of three frame buckets and two word buckets (ids in
    order), with epoch markers at random places when asked for."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        T, W = int(r.choice([64, 128, 256])), int(r.choice([8, 16]))
        out.append({"ids": [i], "mels": np.zeros((2, T, 1)),
                    "word_boundaries": np.zeros((2, W))})
        if epoch_markers and r.rand() < 0.15:
            out.append(None)
    if epoch_markers:
        out.append(None)
    return out


def events(scheduler, stream, k, first_step, total_step, periods, strict):
    return [(event, None if payload is None else [b["ids"][0] for b in payload])
            for event, payload in scheduler(iter(stream), k, first_step, total_step, periods,
                                            strict=strict)]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_schedule_segments_matches_jax(k, strict):
    n_cases = 0
    for periods in ([4, 8, 16, 8], [1, 1000, 1000, 2], [3, 5, 7, 11], [1000, 1000, 1000, 1000]):
        for seed, epoch_markers in ((0, True), (1, False), (2, True)):
            stream = random_stream(seed, 60, epoch_markers)
            for first_step, total_step in ((1, 40), (7, 30), (1, 100)):
                args = (stream, k, first_step, total_step, periods, strict)
                got = events(ttrain.schedule_segments, *args)
                assert got == events(jtrain.schedule_segments, *args), (periods, seed)
                assert all(len(ids) <= k for e, ids in got if e == "run")
                n_cases += 1
    assert n_cases == 36




def resumed_run(stream, k, strict, restore_step, total_step, periods):
    """The train CLI's loop over `stream` (its first batch consumed
    untrained) resumed at `restore_step`: (the batches it skips, the
    batches it trains on)."""
    next(b for b in stream if b is not None)
    done, skipped, trained = 0, [], []
    for event, payload in ttrain.schedule_segments(stream, k, 1, total_step, periods,
                                                   strict=strict):
        if event == "run":
            done += len(payload)
            (skipped if done <= restore_step else trained).extend(payload)
    return skipped, trained


@pytest.mark.parametrize("k,strict", [(1, False), (3, False), (3, True)])
def test_resume_replays_headers_and_trains_on_the_loaded_batches(corpus, k, strict):
    ds = AcousticDataset("train.txt", "naive", *configs(corpus, False), sort=True,
                         drop_last=True)
    periods, total = [3, 1000, 1000, 6], 24
    reordered = False
    for restore in (6, 12, 18):
        replayed = ttrain.replayed_batches(ds, 0, k, strict, 0, restore, total, periods)
        assert len(replayed) == restore + 1 and 0 in replayed
        reordered |= replayed != set(range(restore + 1))
        runs = [resumed_run(ds.batches(group_size=ttrain.GROUP_SIZE, seed=0, replayed=r),
                            k, strict, restore, total, periods) for r in ((), replayed)]
        (want_skipped, want), (got_skipped, got) = runs
        assert len(got) == total - restore
        assert_streams_equal(got, want)
        assert len(got_skipped) == len(want_skipped) == restore
        for g, w in zip(got_skipped, want_skipped):
            assert ttrain.shape_key(g) == ttrain.shape_key(w)
            assert all(g[key].dtype == v.dtype for key, v in w.items() if key not in (
                "ids", "raw_texts"))
            assert not g["mels"].any() and w["mels"].any()
    assert reordered == (k > 1 and not strict)


def batches():
    """STEPS training batches of one shape, from seeds."""
    out = []
    for i in range(STEPS):
        b = tiny_batch(rng=i)
        b["mels"] = np.random.RandomState(i).randn(*b["mels"].shape[:2], N_MELS).astype(
            np.float32)
        out.append(torch_batch(b))
    return out


def fresh(mode, seed=0):
    """A port G and D of the tiny configs, initialised from torch's default
    generator seeded 0, their train state and step; then the default
    generator seeded `seed`."""
    torch.manual_seed(0)
    G, _ = tcommon.build_model(mode, PRE, TINY_MODEL_YAML, device="cpu")
    D = tcommon.build_discriminator(PRE, TINY_MODEL_YAML, device="cpu")
    torch.manual_seed(seed)
    return (create_train_state(G, D, TINY_TRAIN_YAML, TINY_MODEL_YAML),
            make_train_step(mode, G, D, TINY_MODEL_YAML, TINY_TRAIN_YAML))


def snapshot(state):
    """Every tensor of the state's models and optimizers, and its counters."""
    out = {f"G {k}": v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"D {k}": v.clone() for k, v in state.discriminator.state_dict().items()})
    for name in ("opt_g_fs2", "opt_g", "opt_d"):
        opt = getattr(state, name)
        out[f"{name} counters"] = (opt.count, opt.mini_step)
        for part in ("mu", "nu", "acc"):
            for i, t in enumerate(getattr(opt, part) or []):
                out[f"{name} {part} {i}"] = t.clone()
    out["counters"] = (state.step, state.epoch, state.lr_g, state.lr_d)
    return out


def assert_identical(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("mode", ["aux", "naive"])
def test_chunked_steps_equal_sequential_steps(mode):
    state, step_fn = fresh(mode)
    seq = [step_fn(state, b) for b in batches()[:3]]
    want = snapshot(state)

    state, step_fn = fresh(mode)
    stacked = {k: torch.stack([b[k] for b in batches()[:3]]) for k in batches()[0]}
    metrics = chunk_train_step(step_fn)(state, stacked)
    assert_identical(snapshot(state), want)
    assert state.step == 3 and metrics.keys() == seq[0].keys()
    for k, v in metrics.items():
        assert v.shape == (3,) and torch.equal(v, torch.stack([m[k] for m in seq])), k


@pytest.mark.parametrize("mode", ["aux", "naive"])
def test_resume_equals_uninterrupted_steps(mode, tmp_path):
    tc = TINY_TRAIN_YAML

    def start():
        state, step_fn = fresh(mode)
        state.epoch, state.lr_g, state.lr_d = 3, 3e-5, 7e-5   # as after two epochs' decay
        return state, step_fn

    state, step_fn = start()
    want_metrics = [step_fn(state, b) for b in batches()]
    want = snapshot(state)

    state, step_fn = start()
    for b in batches()[:2]:
        step_fn(state, b)
    path = save_checkpoint(str(tmp_path), state, tc, stream_start=1)
    assert path == checkpoint_path(str(tmp_path), 2) and latest_step(str(tmp_path)) == 2
    state, step_fn = fresh(mode, seed=99)   # other random streams until restored
    assert restore_checkpoint(str(tmp_path), state, 2) == 1
    got_metrics = [step_fn(state, b) for b in batches()[2:]]
    assert_identical(snapshot(state), want)
    for got, ref in zip(got_metrics, want_metrics[2:]):
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


def test_handoff_keeps_optimizers_fresh_and_carries_the_epoch(tmp_path):
    tc = TINY_TRAIN_YAML
    state, step_fn = fresh("aux")
    for b in batches()[:2]:
        step_fn(state, b)
    state.epoch = 5
    save_checkpoint(str(tmp_path), state, tc)
    aux = snapshot(state)

    shallow, _ = fresh("shallow", seed=1)
    shallow.step = 2                      # create_train_state(restore_step=2)
    fresh_counters = (shallow.step, shallow.lr_g, shallow.lr_d)
    assert restore_checkpoint(str(tmp_path), shallow, 2, reset_optimizers=True) == 2
    got = snapshot(shallow)
    for k, v in aux.items():
        if k.startswith(("G ", "D ")):
            assert torch.equal(got[k], v), k
    assert shallow.epoch == 5
    assert (shallow.step, shallow.lr_g, shallow.lr_d) == fresh_counters
    for name in ("opt_g_fs2", "opt_g", "opt_d"):
        opt = getattr(shallow, name)
        assert opt.count == opt.mini_step == 0 and opt.mu is None, name

    # a checkpoint of epoch, G and D only, as `mixgantts_tpu.export` writes
    ckpt = torch.load(checkpoint_path(str(tmp_path), 2), weights_only=True)
    torch.save({k: ckpt[k] for k in ("epoch", "G", "D")}, checkpoint_path(str(tmp_path), 3))
    assert restore_checkpoint(str(tmp_path), shallow, 3, reset_optimizers=True) == 3
    with pytest.raises(ValueError, match=r"'step', 'optG_fs2', 'optG', 'optD'"):
        restore_checkpoint(str(tmp_path), shallow, 3)
    with pytest.raises(FileNotFoundError, match="pth.tar"):
        restore_checkpoint(str(tmp_path), shallow, 7)


def test_checkpoint_loads_into_jax(tmp_path):
    """G after an aux step and D after a naive one, through the JAX
    package's converters: aux inference and D's features at rtol 1e-5."""
    tc = TINY_TRAIN_YAML
    state, step_fn = fresh("aux")
    step_fn(state, batches()[0])
    save_checkpoint(str(tmp_path), state, tc)
    ckpt = torch.load(checkpoint_path(str(tmp_path), 1), weights_only=True)
    G = {k: v.numpy() for k, v in ckpt["G"].items()}
    params, batch_stats = convert_generator(G, "aux", encoder_layers=1, decoder_layers=1,
                                            denoiser_layers=2)

    batch = tiny_batch(rng=7)
    text = {k: batch[k] for k in ("speakers", "texts", "src_lens", "word_boundaries",
                                  "src_w_lens")}
    T = 24
    S = state.model.diffusion.num_timesteps
    noises = np.random.RandomState(8).randn(S, 2, T, N_MELS).astype(np.float32)
    jmodel, _ = jcommon.build_model("aux", PRE, TINY_MODEL_YAML)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_trace(mp, [noises])
        apply = jax.jit(jmodel.apply, static_argnames=("max_mel_len", "train"))
        want = apply({"params": params, "batch_stats": batch_stats}, **text, max_mel_len=T,
                     train=False, rngs={"diffusion": jax.random.PRNGKey(0)})
    port = state.model
    with torch.no_grad():
        got = port(**{k: torch.as_tensor(v) for k, v in text.items()}, max_mel_len=T,
                   noise_override={"trace_noises": torch.from_numpy(noises)})
    assert_close(got.mel_pred, want.mel_pred, rtol=1e-5, atol=1e-6, msg="aux trace")
    np.testing.assert_array_equal(got.mel_lens.numpy(), np.asarray(want.mel_lens))

    naive, step_fn = fresh("naive")
    step_fn(naive, batches()[0])
    save_checkpoint(str(tmp_path / "naive"), naive, tc)
    D = torch.load(checkpoint_path(str(tmp_path / "naive"), 1), weights_only=True)["D"]
    d_params = convert_discriminator({k: v.numpy() for k, v in D.items()})
    r = np.random.RandomState(9)
    x, y = (r.randn(2, 12, N_MELS).astype(np.float32) for _ in range(2))
    t = np.array([0, naive.model.diffusion.num_timesteps - 1])
    jdisc = jcommon.build_discriminator(PRE, TINY_MODEL_YAML)
    want_c, want_u = jax.jit(jdisc.apply)({"params": d_params}, x, y, None, t)
    with torch.no_grad():
        got_c, got_u = naive.discriminator(torch.from_numpy(x), torch.from_numpy(y), None,
                                           torch.from_numpy(t))
    for g, w in zip(list(got_c) + list(got_u), list(want_c) + list(want_u)):
        assert_close(g, w, rtol=1e-5, atol=1e-6, msg="D features")


def test_optimizer_entries_load_into_torch(tmp_path):
    """torch.optim.Adam loads optG, optD and optG_fs2 (their moments on
    the parameters' indices); ExponentialLR loads sdlG and sdlD."""
    tc = TINY_TRAIN_YAML
    state, step_fn = fresh("naive")
    step_fn(state, batches()[0])
    state.epoch, state.lr_g = 3, state.lr_g * tc["optimizer"]["gamma"] ** 2
    save_checkpoint(str(tmp_path), state, tc)
    ckpt = torch.load(checkpoint_path(str(tmp_path), 1), weights_only=True)
    for key, module, opt in (("optG", state.model, state.opt_g),
                             ("optD", state.discriminator, state.opt_d),
                             ("optG_fs2", state.model, state.opt_g_fs2)):
        params = [copy.deepcopy(p) for p in module.parameters()]
        adam = torch.optim.Adam(params)
        adam.load_state_dict(ckpt[key])
        loaded = adam.state_dict()["state"]
        if opt.mu is None:
            assert not loaded, key
            continue
        assert len(loaded) == len(params)
        assert torch.equal(loaded[0]["exp_avg"], opt.mu[0]) and float(loaded[0]["step"]) == 1.0
        adam.step()   # the loaded state steps
    assert ckpt["optG"]["param_groups"][0]["lr"] == pytest.approx(state.lr_g)
    sched = torch.optim.lr_scheduler.ExponentialLR(
        torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=tc["optimizer"]["init_lr_G"]),
        gamma=tc["optimizer"]["gamma"])
    sched.load_state_dict(ckpt["sdlG"])
    assert sched.last_epoch == 2 and sched.get_last_lr()[0] == pytest.approx(state.lr_g)
    assert {"epoch", "G", "D", "sdlD"} <= set(ckpt)
    assert sorted(os.listdir(tmp_path)) == ["1.pth.tar", "latest"]   # no temporary file left
