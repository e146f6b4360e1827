"""Validation pass (`mixgantts_tpu/cli/evaluate.py`): the whole of
`val.txt` through the step's losses without updates, each loss averaged
over utterances, and one sample panel logged.

    python -m mixgantts_tpu_torch.cli.evaluate --restore_step 200000 \
        --model shallow --dataset LJSpeech

runs on the GPU; `cli(argv, device="cpu")` runs on the CPU.  It restores
G and D only (as at the aux -> shallow handoff), so a checkpoint of
epoch, G and D, as `python -m mixgantts_tpu.export` writes, serves.
"""

import argparse

import torch

from ..checkpoint import restore_checkpoint
from ..data.dataset import AcousticDataset
from ..data.prefetch import prefetch
from ..train import create_train_state, make_eval_step
from ..utils.logging import LOSS_KEYS, log, loss_message
from ..utils.tools import resolve_device
from .common import build_discriminator, build_model, load_configs, to_device


def evaluate(mode, model, discriminator, state, configs, logger=None, vocoder=None,
             eval_fn=None, max_batches=None):
    """The loss line of `state` on val.txt (batch i draws its diffusion
    noise from a generator seeded i), logged with a sample panel when a
    logger (and a vocoder) is given."""
    preprocess_config, model_config, train_config = configs
    device = next(model.parameters()).device
    if eval_fn is None:
        eval_fn = make_eval_step(mode, model, discriminator, model_config, train_config)
    dataset = AcousticDataset("val.txt", mode, preprocess_config, model_config, train_config,
                              sort=False, drop_last=False)
    sums = {k: 0.0 for k in LOSS_KEYS}
    n_samples = 0
    first_batch = None
    for i, batch in enumerate(prefetch(dataset.batches(group_size=1, shuffle=False,
                                                       epochs=1))):
        if batch is None or (max_batches is not None and i >= max_batches):
            break
        if first_batch is None:
            first_batch = batch
        losses = eval_fn(state, to_device(batch, device),
                         generator=torch.Generator(device).manual_seed(i))
        keys = [k for k in LOSS_KEYS if k in losses]
        values = torch.stack([losses[k].float() for k in keys]).cpu().tolist()
        bsz = len(batch["ids"])
        for k, v in zip(keys, values):
            sums[k] += v * bsz
        n_samples += bsz

    means = {k: v / max(n_samples, 1) for k, v in sums.items()}
    step = state.step
    message = loss_message(step, train_config["step"][f"total_step_{mode}"], means)
    if logger is not None:
        log(logger, step, losses=means)
        if vocoder is not None and first_batch is not None:
            from .train import synthesize_sample
            figs, attn_fig, wav_rec, wav_pred, tag = synthesize_sample(
                mode, model, state, first_batch, vocoder, model_config, preprocess_config)
            sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
            log(logger, step, figs=figs, tag="Validation")
            log(logger, figs=attn_fig, tag=f"Validation_attn/step_{step}_{tag}")
            log(logger, step, audio=wav_rec, sampling_rate=sr, tag="Validation/reconstructed")
            log(logger, step, audio=wav_pred, sampling_rate=sr, tag="Validation/synthesized")
    return message


def cli(argv=None, device=None):
    """Parse `argv` (default sys.argv) and evaluate on `device` (default
    cuda; raises where there is none).  Returns the loss line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--path_tag", type=str, default="")
    parser.add_argument("--model", type=str, choices=["naive", "aux", "shallow"], required=True)
    parser.add_argument("--dataset", type=str, required=True)
    args = parser.parse_args(argv)
    device = resolve_device(device)
    configs = load_configs(args)
    preprocess_config, model_config, train_config = configs
    model, _ = build_model(args.model, preprocess_config, model_config, device=device)
    disc = build_discriminator(preprocess_config, model_config, device=device)
    state = create_train_state(model, disc, train_config, model_config,
                               restore_step=args.restore_step)
    if args.restore_step:
        restore_checkpoint(train_config["path"]["ckpt_path"], state, args.restore_step,
                           reset_optimizers=True)
    message = evaluate(args.model, model, disc, state, configs)
    print(message)
    return message


if __name__ == "__main__":
    cli()
