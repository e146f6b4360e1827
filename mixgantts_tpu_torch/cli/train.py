"""Training CLI (`mixgantts_tpu/cli/train.py`): grouped sorted batches from
`train.txt`, the mode's train step, periodic console, `log.txt` and
TensorBoard logging, sample panels, validation and checkpoints, and the
per-epoch ExponentialLR decay of the GAN learning rates.

    python -m mixgantts_tpu_torch.cli.train --model aux --dataset LJSpeech
    python -m mixgantts_tpu_torch.cli.train --model shallow --dataset LJSpeech \
        --restore_step 200000

runs on the GPU; `main(args, configs, device="cpu")` or `cli(argv,
device="cpu")` runs on the CPU.  Checkpoints are `{ckpt_path}/{step}.pth.tar`
(`checkpoint.py`); shallow training starts from the finished aux
checkpoint, with fresh optimizers.

Steps run in segments of up to `steps_per_call` same-shape batches
(`schedule_segments`), each one `chunk_train_step` call read back with one
copy to the host.

Multi-GPU training is one rank per card, launched by torchrun:

    torchrun --nproc_per_node N -m mixgantts_tpu_torch.cli.train --model shallow \
        --dataset LJSpeech --restore_step 200000 --data_parallel [--tensor_parallel M]

The mesh is (N / M, M) (`parallel.make_mesh`): every rank reads the same
batch stream and keeps its rows of each batch, the state is broadcast
from rank 0 and, with M > 1, Megatron-sharded (`parallel.shard_state`),
and the steps run through `parallel.shard_train_step`, which computes the
one-GPU step on the global batch.  Only rank 0 logs, writes panels,
validates and saves (a one-GPU checkpoint): for the panels, validation and
the save every rank gathers the tensor-parallel shards
(`parallel.gather_state`), so rank 0 runs them on the full weights, as a
one-GPU run does (the serving kernels included).  With one rank the flags
run unsharded.  `--profile_dir` traces a few steady-state
steps (each rank into `<dir>/rank<r>`) and `--profile_port` serves
on-demand captures (`utils/profiling.py`).  A resumed run replays its batch stream from the
checkpoint's `stream_start` without training on it, so it sees the batches
the uninterrupted run saw; the JAX CLI restarts its stream instead.  The
replayed batches are built from the `.npy` headers alone
(`replayed_batches`): a resume reads none of their arrays.
"""

import argparse
import os
import sys

import numpy as np
import torch

from ..checkpoint import restore_checkpoint, save_checkpoint
from ..data.dataset import AcousticDataset
from ..data.prefetch import prefetch
from ..models.vocoder import get_vocoder
from ..parallel import (
    gather_state, init_distributed, make_mesh, replicate_state, shard_batch, shard_state,
    shard_train_step,
)
from ..train import (check_finite_metrics, chunk_train_step, create_train_state, debug_nans,
                     make_eval_step, make_train_step)
from ..train.optim import fs2_lr_schedule
from ..train.step import model_kwargs
from ..utils.logging import NullWriter, get_writer, log, loss_message
from ..utils.profiling import StepProfiler, ThroughputMeter, start_server
from ..utils.synth import synth_one_sample
from ..utils.tools import resolve_device
from .common import (build_discriminator, build_model, load_configs, model_batch_of,
                     param_count, to_device)
from .evaluate import evaluate

# the training targets, which inference does without
TARGET_KEYS = ("mels", "mel_lens", "p_targets", "e_targets", "d_targets", "attn_priors")
GROUP_SIZE = 4   # batches of a draw from the shuffled corpus (`AcousticDataset.batches`)


def synthesize_sample(mode, model, state, batch, vocoder, model_config, preprocess_config):
    """The panels of a host batch's first utterance (`synth_one_sample`):
    the model in eval mode on the batch (diffusion noise seeded with the
    step) and, in naive and shallow modes, the inference trace from its
    text alone (seeded with the step + 1), through the serving kernels."""
    device = next(model.parameters()).device
    kwargs = model_kwargs(to_device(batch, device))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = model(**kwargs, generator=torch.Generator(device).manual_seed(state.step))
            trace = None
            if mode != "aux":
                infer = {k: v for k, v in kwargs.items() if k not in TARGET_KEYS}
                trace = model(**infer, return_trace=True, generator=torch.Generator(
                    device).manual_seed(state.step + 1)).mel_pred
    finally:
        model.train(was_training)
    return synth_one_sample(mode, batch, out, trace, vocoder, model_config, preprocess_config,
                            model.diffusion)


def training_mesh(args, device):
    """(mesh or None, device) of a run: with `--data_parallel` or
    `--tensor_parallel` M > 1 under a launcher of several ranks, the
    (world / M, M) mesh of the process group and this rank's card; else
    none, and `device` (default cuda; raises where there is none)."""
    tp = max(1, int(getattr(args, "tensor_parallel", 1) or 1))
    if getattr(args, "data_parallel", False) or tp > 1:
        _, world, rank_device = init_distributed(device)
        if world > 1:
            return make_mesh(model_axis=tp), rank_device
        print("one rank: --data_parallel / --tensor_parallel run unsharded")
    return None, resolve_device(device)


def main(args, configs, device=None):
    """Train `args.model` from `args.restore_step` to the mode's total step
    on `device` (default cuda; raises where there is none), or on this
    rank's card of a multi-GPU run (see the module docstring)."""
    mesh, device = training_mesh(args, device)
    lead = mesh is None or mesh.rank == 0   # logs, writes panels, validates, saves
    preprocess_config, model_config, train_config = configs
    mode = args.model
    cfg_step = train_config["step"]
    ckpt_path = train_config["path"]["ckpt_path"]

    torch.manual_seed(args.seed)
    model, _ = build_model(mode, preprocess_config, model_config, device=device)
    discriminator = build_discriminator(preprocess_config, model_config, device=device)
    state = create_train_state(model, discriminator, train_config, model_config,
                               restore_step=args.restore_step,
                               generator=torch.Generator(device).manual_seed(args.seed))
    if mesh is not None:
        replicate_state(mesh, state)
    stream_start = 0
    if args.restore_step:
        stream_start = restore_checkpoint(
            ckpt_path, state, args.restore_step,
            reset_optimizers=args.restore_step == cfg_step["total_step_aux"])

    if mesh is not None and mesh.shape["model"] > 1:
        shard_state(mesh, state)

    tpu_cfg = model_config.get("tpu", {}) or {}
    k = max(1, int(getattr(args, "steps_per_call", 0) or tpu_cfg.get("steps_per_call", 1)))
    strict = bool(tpu_cfg.get("strict_batch_order", False))
    total_step = cfg_step[f"total_step_{mode}"]
    periods = [cfg_step["log_step"], cfg_step["synth_step"], cfg_step["val_step"],
               cfg_step["save_step"]]

    dataset = AcousticDataset("train.txt", mode, preprocess_config, model_config,
                              train_config, sort=True, drop_last=True)
    # what a resume replays untrained is built from the arrays' headers alone
    replayed = replayed_batches(dataset, args.seed, k, strict, stream_start,
                                args.restore_step, total_step, periods)
    batch_gen = prefetch(dataset.batches(group_size=GROUP_SIZE, shuffle=True, seed=args.seed,
                                         replayed=replayed))
    # the JAX CLI initialises its state on the stream's first batch and
    # trains from the second: step n sees its batch n here too
    next(b for b in batch_gen if b is not None)

    step_fn = make_train_step(mode, model, discriminator, model_config, train_config)
    chunk_fn = chunk_train_step(step_fn)
    if mesh is not None:
        chunk_fn = shard_train_step(chunk_fn, mesh)
    eval_fn = make_eval_step(mode, model, discriminator, model_config, train_config)

    vocoder = None
    if lead:
        try:
            vocoder = get_vocoder(
                model_config,
                num_mels=preprocess_config["preprocessing"]["mel"]["n_mel_channels"],
                device=device)
        except Exception as e:  # the vocoder serves only the panels
            print(f"vocoder unavailable ({e}); logging without audio")

    for p in train_config["path"].values():
        os.makedirs(p, exist_ok=True)
    train_log_path = os.path.join(train_config["path"]["log_path"], "train")
    val_log_path = os.path.join(train_config["path"]["log_path"], "val")
    os.makedirs(train_log_path, exist_ok=True)
    os.makedirs(val_log_path, exist_ok=True)
    train_logger = get_writer(train_log_path) if lead else NullWriter()
    val_logger = get_writer(val_log_path) if lead else NullWriter()
    if lead and isinstance(train_logger, NullWriter):
        print("neither tensorboardX nor torch.utils.tensorboard imports: no TensorBoard "
              "events are written (the console and log.txt lines are)")

    if lead:
        print("Number of MixGAN-TTS Parameters     :", param_count(model))
        print("          JCUDiscriminator Parameters:", param_count(discriminator))

    gamma = train_config["optimizer"]["gamma"]
    fs2 = train_config["optimizer_fs2"]
    fs2_sched = fs2_lr_schedule(model_config["transformer"]["encoder_hidden"],
                                fs2["warm_up_step"], fs2["anneal_steps"], fs2["anneal_rate"])
    sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
    meter = ThroughputMeter()

    profile_dir = getattr(args, "profile_dir", None)
    if profile_dir and mesh is not None:
        profile_dir = os.path.join(profile_dir, f"rank{mesh.rank}")
    # capture steady-state steps; clamp the window into short runs
    profile_start = min(args.restore_step + 10, max(args.restore_step + 1, total_step - 4))
    profiler = StepProfiler(profile_dir, profile_start)
    server = None
    if getattr(args, "profile_port", 0):
        port = args.profile_port + (mesh.rank if mesh is not None else 0)
        server = start_server(port, profiler,
                              default_dir=os.path.join(train_config["path"]["log_path"],
                                                       "profile"))
        print(f"profiler server listening on localhost:{port} "
              f"(GET /?steps=K&dir=DIR arms a capture of K steps)")

    def run_segment(batch_list):
        first = state.step + 1
        profiler.step(first)
        stacked = {key: np.stack([b[key] for b in batch_list])
                   for key in model_batch_of(batch_list[0])}
        if mesh is not None:
            stacked = shard_batch(mesh, stacked, stacked=True)
        metrics = chunk_fn(state, to_device(stacked, device))
        keys = list(metrics)
        values = torch.stack([metrics[key] for key in keys]).cpu().numpy()  # one host sync
        for j, batch in enumerate(batch_list):
            s = first + j
            meter.update(batch["mel_lens"])

            if s % cfg_step["log_step"] == 0:
                ms = dict(zip(keys, values[:, j]))
                check_finite_metrics(ms, s)
                if lead:
                    msg = loss_message(s, total_step, ms)
                    it_s, frames_s = meter.read_and_reset()
                    print(f"{msg}  ({it_s:.2f} it/s, {frames_s:.0f} mel-frames/s)")
                    with open(os.path.join(train_log_path, "log.txt"), "a") as f:
                        f.write(f"Step {s}/{total_step}, " + msg.split(", ", 1)[1] + "\n")
                    log(train_logger, s, losses=ms,
                        lr=state.lr_g if mode != "aux" else fs2_sched(s))
                    train_logger.add_scalar("Training/mel_frames_per_sec", frames_s, s)

            panel = s % cfg_step["synth_step"] == 0
            validate = s % cfg_step["val_step"] == 0
            if panel or validate:
                # every rank gathers the shards; rank 0 runs on the full weights
                with gather_state(state):
                    if lead and panel and vocoder is not None:
                        figs, attn_fig, wav_rec, wav_pred, tag = synthesize_sample(
                            mode, model, state, batch, vocoder, model_config,
                            preprocess_config)
                        log(train_logger, s, figs=figs, tag="Training")
                        log(train_logger, figs=attn_fig, tag=f"Training_attn/step_{s}_{tag}")
                        log(train_logger, s, audio=wav_rec, sampling_rate=sr,
                            tag="Training/reconstructed")
                        log(train_logger, s, audio=wav_pred, sampling_rate=sr,
                            tag="Training/synthesized")
                    if lead and validate:
                        message = evaluate(mode, model, discriminator, state, configs,
                                           val_logger, vocoder, eval_fn)
                        with open(os.path.join(val_log_path, "log.txt"), "a") as f:
                            f.write(message + "\n")
                        print(message)

            if s % cfg_step["save_step"] == 0:
                path = save_checkpoint(ckpt_path, state, train_config, stream_start)
                if lead:
                    print(f"saved checkpoint: {path}")

            if s >= total_step:
                profiler.close()
                return True
        return False

    # `done` counts the stream's steps; those up to the restored step are
    # the checkpoint's, replayed without training (segments end at save
    # steps, so none straddles it), as are epoch ends before it
    done = stream_start
    for event, payload in schedule_segments(batch_gen, k, stream_start + 1, total_step,
                                            periods, strict=strict):
        if event == "epoch":
            if done < args.restore_step:
                continue
            state.epoch += 1
            if mode != "aux":   # aux lr is Noam-scheduled, but the epoch is kept true
                state.lr_g *= gamma
                state.lr_d *= gamma
            continue
        done += len(payload)
        if done <= args.restore_step:
            continue
        if run_segment(payload):
            break
    profiler.close()
    if server is not None:
        server.shutdown()
    train_logger.close()
    val_logger.close()


def replayed_batches(dataset, seed, k, strict, stream_start, restore_step, total_step,
                     periods):
    """The stream positions (counting batches from 0) of the batches a run
    resumed at `restore_step` takes without training on them: the first,
    which the JAX CLI initialises on, and those of the steps after
    `stream_start` up to `restore_step`.  With k > 1 the scheduler takes
    batches out of arrival order, so which ones these are follows from
    replaying it, here on batches built from the `.npy` headers alone (it
    reads only their shapes), as the run then replays it."""
    replayed = {0}
    if restore_step <= stream_start:
        return replayed

    def numbered():
        position = 0
        for batch in dataset.batches(group_size=GROUP_SIZE, shuffle=True, seed=seed,
                                     replayed=range(sys.maxsize)):
            if batch is None:
                yield None
            else:
                yield position, batch
                position += 1

    stream = numbered()
    next(item for item in stream if item is not None)
    done = stream_start
    for event, payload in schedule_segments(stream, k, stream_start + 1, total_step, periods,
                                            strict=strict, key_fn=lambda item: shape_key(item[1])):
        if event == "epoch":
            continue
        done += len(payload)
        if done > restore_step:
            break
        replayed.update(position for position, _ in payload)
    return replayed


def shape_key(batch):
    """The FULL tuple of device-batch leaf shapes (not just mel/text
    lengths): word_boundaries pads to its own phone bucket, so two batches
    can share (mel_len, text_len) but differ on the word axis — np.stack
    would raise on a mixed chunk."""
    return tuple(sorted(
        (name, np.shape(v)) for name, v in model_batch_of(batch).items()))


def schedule_segments(batch_stream, k, first_step, total_step, periods,
                      strict=False, key_fn=shape_key):
    """Chunk-dispatch scheduler: turns a stream of batches (None = epoch
    boundary) into ('run', [batches]) segments of <= k same-shape batches
    plus ('epoch', None) markers, stopping after total_step batches.

    Segments never cross a periodic-action boundary (log/synth/val/save
    see the state at exactly the reference step) or total_step.  Batches
    buffer per shape key until k of one shape are available; partial
    buffers flush at epoch boundaries and end of stream.

    With k > 1 the default mode consumes batches grouped by shape rather
    than in strict arrival order, so the data order a given step sees can
    depart from the reference/k=1 trajectory whenever the corpus spans
    multiple shape buckets (each batch still trains exactly once; only
    the interleaving differs).  `strict=True` keeps ONE buffer and
    flushes it (partially) whenever the incoming shape changes: exact
    reference order at every step, at the cost of shorter scans on
    shape-alternating corpora (sorted-group batching clusters same-shape
    batches, so most of the chunking win survives)."""
    step = first_step
    buffers = {}
    buf_key = None

    def until_boundary(s):
        return min(p - ((s - 1) % p) for p in periods)

    def emit(batch_list):
        nonlocal step
        while batch_list and step <= total_step:
            cap = max(1, min(total_step - step + 1, k,
                             until_boundary(step)))
            seg, batch_list = batch_list[:cap], batch_list[cap:]
            step += len(seg)
            yield ("run", seg)

    for batch in batch_stream:
        if step > total_step:
            return
        if batch is None:  # epoch boundary: flush all pending buffers
            for key in list(buffers):
                yield from emit(buffers.pop(key))
                if step > total_step:
                    return
            yield ("epoch", None)
            continue

        key = key_fn(batch)
        if strict:
            buf = buffers.setdefault("__order__", [])
            if buf and buf_key != key:
                # shape changed: flush the pending run in arrival order
                yield from emit(buffers.pop("__order__"))
                buf = buffers.setdefault("__order__", [])
            buf_key = key
            key = "__order__"
        else:
            buf = buffers.setdefault(key, [])
        buf.append(batch)
        # cap the chunk at total_step and at periodic-action boundaries
        if len(buf) >= max(1, min(k, total_step - step + 1,
                                  until_boundary(step))):
            yield from emit(buffers.pop(key))

    # end of a FINITE stream without a trailing epoch marker: flush the
    # partial buffers rather than silently dropping tail batches (the
    # train CLI's generator always ends epochs with None; this covers
    # any other caller feeding a plain batch list)
    for key in list(buffers):
        yield from emit(buffers.pop(key))
        if step > total_step:
            return


def build_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--path_tag", type=str, default="")
    parser.add_argument("--model", type=str, choices=["naive", "aux", "shallow"],
                        required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard the batch over the ranks of a torchrun launch "
                             "(one per GPU)")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="Megatron-shard the weights over this many ranks "
                             "(mesh: world / N data x N model)")
    parser.add_argument("--steps_per_call", type=int, default=0,
                        help="train steps per segment read back with one host copy; "
                             "0 = tpu.steps_per_call from model.yaml")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace steady-state steps into this dir (torch.profiler; "
                             "each rank into <dir>/rank<r>)")
    parser.add_argument("--profile_port", type=int, default=0,
                        help="serve on-demand captures on localhost:PORT (+ rank): "
                             "GET /?steps=K&dir=DIR")
    parser.add_argument("--debug_nans", action="store_true",
                        help="autograd anomaly mode: name the operation whose backward "
                             "produced the first NaN (slow; for triage)")
    return parser


def cli(argv=None, device=None):
    """Parse `argv` (default sys.argv) and train on `device` (default cuda;
    raises where there is none)."""
    args = build_argparser().parse_args(argv)
    configs = load_configs(args)
    preprocess_config, model_config, train_config = configs
    print("\n========================= Training Configuration =========================")
    print(" ---> Type of Modeling:", args.model)
    if model_config["multi_speaker"]:
        print(" ---> Type of Speaker Embedder:",
              preprocess_config["preprocessing"].get("speaker_embedder"))
    print(" ---> Total Batch Size:", int(train_config["optimizer"]["batch_size"]))
    print(" ---> Path of ckpt:", train_config["path"]["ckpt_path"])
    print(" ---> Path of log:", train_config["path"]["log_path"])
    print(" ---> Path of result:", train_config["path"]["result_path"])
    print("==========================================================================")
    with debug_nans(args.debug_nans):
        main(args, configs, device)


if __name__ == "__main__":
    cli()
