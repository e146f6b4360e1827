"""Synthesis CLI (`mixgantts_tpu/cli/synthesize.py`): raw text, a batch
source file, or (`--teacher_forced`) val.txt's utterances driven by their
duration, pitch and energy targets, to wav files, with pitch/energy/
duration control.

    python -m mixgantts_tpu_torch.cli.synthesize --restore_step 200000 \
        --model shallow --mode single --text "..." --dataset LJSpeech

runs on the GPU; `cli(argv, device="cpu")` runs on the CPU.  The generator
comes from `{ckpt_path}/{restore_step}.pth.tar` (the reference's format;
restore_step 0 keeps the random init), the vocoder from `get_vocoder`, and
results go to `{result_path}/{restore_step}/`.  As in the reference, the
`--energy_control` value reaches the model but energy follows p_control.
`--data_parallel` serves text batches over a mesh of every visible card
(one replica each; the CPU alone where `device` is the CPU).
"""

import argparse
import json
import os

import numpy as np
import torch

from ..data.dataset import AcousticDataset, TextOnlyDataset
from ..frontend import preprocess_english, preprocess_mandarin
from ..models.vocoder import get_vocoder
from ..parallel import make_mesh, visible_devices
from ..pipeline import TTSPipeline
from ..train.step import model_kwargs
from ..utils.synth import synth_samples, write_results
from .common import build_model, load_configs, model_batch_of, restore_generator, to_device


def synthesize(model, args, configs, vocoder, batches, control_values):
    """Every batch through `TTSPipeline.stream` (batch i draws its noise
    from seed i; over a mesh of every visible card with
    `--data_parallel`), written by `write_results`.  Returns (wav path, mel
    length) per utterance."""
    preprocess_config, model_config, train_config = configs
    pitch_control, energy_control, duration_control = control_values
    mesh = None
    if getattr(args, "data_parallel", False):
        device = next(model.parameters()).device
        mesh = make_mesh(visible_devices() if device.type == "cuda" else [device])
    pipeline = TTSPipeline(model, vocoder, preprocess_config, model_config, mesh=mesh)
    results = pipeline.stream(
        [model_batch_of(b) for b in batches], p_control=pitch_control,
        e_control=energy_control, d_control=duration_control, return_mel=True)
    written = []
    for batch, (wavs, mels, mel_lens) in zip(batches, results):
        paths = write_results(args, batch["ids"], mels, mel_lens, wavs, model_config,
                              preprocess_config, train_config["path"]["result_path"])
        written += [(p, int(n)) for p, n in zip(paths, mel_lens)]
    return written


def synthesize_teacher_forced(model, args, configs, vocoder, batches, control_values):
    """Each batch of `val.txt` with its duration, pitch and energy targets
    driving the model (batch i draws its noise from a generator seeded i),
    written by `synth_samples`.  Returns (wav path, mel length) per
    utterance."""
    preprocess_config, model_config, train_config = configs
    pitch_control, energy_control, duration_control = control_values
    device = next(model.parameters()).device
    written = []
    for i, batch in enumerate(batches):
        kwargs = model_kwargs(to_device(batch, device))
        del kwargs["mels"], kwargs["mel_lens"]
        with torch.no_grad():
            out = model(**kwargs, p_control=pitch_control, e_control=energy_control,
                        d_control=duration_control,
                        generator=torch.Generator(device).manual_seed(i))
        paths = synth_samples(args, batch, out, vocoder, model_config, preprocess_config,
                              train_config["path"]["result_path"], model.diffusion)
        written += [(p, int(n)) for p, n in zip(paths, out.mel_lens.tolist())]
    return written


def build_single_batch(args, preprocess_config, model_config):
    """The batch of `--text`: its phone ids and word boundaries, the index
    of `--speaker_id` in speakers.json for a multi-speaker model, and that
    speaker's `spker_embed/{speaker_id}-spker_embed.npy` for one with an
    external speaker embedder."""
    ids = raw_texts = [args.text[:100]]
    pp = preprocess_config["path"]["preprocessed_path"]
    if model_config["multi_speaker"]:
        with open(os.path.join(pp, "speakers.json")) as f:
            speakers = np.array([json.load(f)[str(args.speaker_id)]])
    else:
        speakers = np.array([0])
    lang = preprocess_config["preprocessing"]["text"]["language"]
    fn = preprocess_english if lang == "en" else preprocess_mandarin
    texts, word_boundaries = fn(args.text, preprocess_config)
    batch = {
        "ids": ids,
        "raw_texts": raw_texts,
        "speakers": speakers,
        "texts": texts[None].astype(np.int64),
        "src_lens": np.array([len(texts)]),
        "word_boundaries": word_boundaries[None].astype(np.int64),
        "src_w_lens": np.array([len(word_boundaries)]),
    }
    if (model_config["multi_speaker"]
            and preprocess_config["preprocessing"].get("speaker_embedder", "none") != "none"):
        batch["spker_embeds"] = np.load(os.path.join(
            pp, "spker_embed", f"{args.speaker_id}-spker_embed.npy")).reshape(1, -1).astype(np.float32)
    return batch


def build_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_step", type=int, required=True)
    parser.add_argument("--path_tag", type=str, default="")
    parser.add_argument("--model", type=str, choices=["naive", "aux", "shallow"],
                        required=True)
    parser.add_argument("--teacher_forced", action="store_true")
    parser.add_argument("--mode", type=str, choices=["batch", "single"], required=True)
    parser.add_argument("--source", type=str, default=None)
    parser.add_argument("--text", type=str, default=None)
    parser.add_argument("--speaker_id", type=int, default=42)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument(
        "--data_parallel", action="store_true",
        help="shard batched synthesis over all visible GPUs, one replica each")
    return parser


def cli(argv=None, device=None):
    """Parse `argv` (default sys.argv) and synthesize on `device` (default
    cuda; raises where there is none).  Returns (wav path, mel length) per
    utterance written."""
    args = build_argparser().parse_args(argv)
    # the JAX CLI's argument checks, as AssertionError, but kept under -O
    if args.mode == "batch" and (args.text is not None
                                 or (args.source is None) != args.teacher_forced):
        raise AssertionError("batch mode takes --source (no --text), or "
                             "--teacher_forced without --source")
    if args.mode == "single" and (args.source is not None or args.text is None
                                  or args.teacher_forced):
        raise AssertionError("single mode takes --text only")
    configs = load_configs(args)
    preprocess_config, model_config, train_config = configs
    model, _ = build_model(args.model, preprocess_config, model_config, device=device)
    if args.restore_step:
        restore_generator(model, train_config["path"]["ckpt_path"], args.restore_step)
    vocoder = get_vocoder(
        model_config, num_mels=preprocess_config["preprocessing"]["mel"]["n_mel_channels"],
        device=device)

    controls = (args.pitch_control, args.energy_control, args.duration_control)
    if args.teacher_forced:
        dataset = AcousticDataset("val.txt", args.model, preprocess_config, model_config,
                                  train_config, sort=False, drop_last=False)
        batches = [b for b in dataset.batches(group_size=1, shuffle=False, epochs=1)
                   if b is not None]
        return synthesize_teacher_forced(model, args, configs, vocoder, batches, controls)
    if args.mode == "batch":
        batches = list(TextOnlyDataset(args.source, preprocess_config,
                                       model_config).batches(batch_size=8))
    else:
        batches = [build_single_batch(args, preprocess_config, model_config)]
    return synthesize(model, args, configs, vocoder, batches, controls)


if __name__ == "__main__":
    cli()
