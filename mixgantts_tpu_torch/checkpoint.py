"""Checkpoints (`mixgantts_tpu/checkpoint.py`) as the reference's
`.pth.tar`: `{ckpt_path}/{step}.pth.tar`, one per `save_step`, and a
`latest` marker holding the newest step.  Writes are atomic (a temporary
file, then `os.replace`).

The reference's keys, in its layouts: `epoch`; `G` and `D`, the port's
`state_dict`s, which are the reference's (what
`mixgantts_tpu/convert.py::convert_generator` and `convert_discriminator`
read; G's buffers derived from the config and statistics are not written,
and the port derives them on load); `optG_fs2`, `optG` and `optD` in
`torch.optim.Adam.state_dict()`'s shape (`train/optim.py::Adam.state_dict`);
`sdlG` and `sdlD` in `ExponentialLR.state_dict()`'s.  Exact resume also
needs the port's own keys: `step`, `lr_g` and `lr_d`, `rng` (the state's
`torch.Generator`, and torch's default CPU and CUDA generators, which
dropout draws from), and `stream_start`, the step after which the run's
batch stream began (the train CLI replays the stream from there, so a
resumed run sees the batches the uninterrupted one saw).

Restoring at the aux -> shallow handoff (`reset_optimizers=True`) loads the
weights and the epoch and leaves the optimizers, step and learning rates
fresh, so a file with only {epoch, G, D}, as `python -m mixgantts_tpu.export`
writes from an orbax checkpoint, restores there.  The port reads no orbax
directory.
"""

import os

import torch

from .convert import load_reference_generator

WEIGHT_KEYS = ("epoch", "G", "D")
RESUME_KEYS = ("step", "optG_fs2", "optG", "optD", "lr_g", "lr_d", "rng", "stream_start")


def checkpoint_path(ckpt_path, step):
    return os.path.join(ckpt_path, f"{step}.pth.tar")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _write_atomic(path, save):
    tmp = f"{path}.tmp"
    save(tmp)
    os.replace(tmp, path)


def _exponential_lr_state(init_lr, gamma, epoch, lr):
    """`torch.optim.lr_scheduler.ExponentialLR.state_dict()` after epoch - 1
    epoch steps."""
    return {"gamma": float(gamma), "base_lrs": [float(init_lr)], "last_epoch": epoch - 1,
            "verbose": False, "_step_count": epoch, "_get_lr_called_within_step": False,
            "_last_lr": [float(lr)]}


def save_checkpoint(ckpt_path, state, train_config, stream_start=0):
    """Write `state` as `{ckpt_path}/{state.step}.pth.tar` and mark it the
    latest; returns the file's path.  `train_config` gives the schedulers'
    initial learning rates and gamma."""
    opt = train_config["optimizer"]
    rng = {"generator": state.generator.get_state(), "cpu": torch.get_rng_state(),
           "cuda": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else []}
    ckpt = _cpu({
        "epoch": state.epoch,
        "G": state.model.state_dict(),
        "D": state.discriminator.state_dict(),
        "optG_fs2": state.opt_g_fs2.state_dict(),
        "optG": state.opt_g.state_dict(state.lr_g),
        "optD": state.opt_d.state_dict(state.lr_d),
        "sdlG": _exponential_lr_state(opt["init_lr_G"], opt["gamma"], state.epoch, state.lr_g),
        "sdlD": _exponential_lr_state(opt["init_lr_D"], opt["gamma"], state.epoch, state.lr_d),
        "step": state.step, "lr_g": state.lr_g, "lr_d": state.lr_d, "rng": rng,
        "stream_start": stream_start,
    })
    os.makedirs(ckpt_path, exist_ok=True)
    path = checkpoint_path(ckpt_path, state.step)
    _write_atomic(path, lambda tmp: torch.save(ckpt, tmp))

    def mark(tmp):
        with open(tmp, "w") as f:
            f.write(str(state.step))

    _write_atomic(os.path.join(ckpt_path, "latest"), mark)
    return path


def latest_step(ckpt_path):
    """The newest saved step (the `latest` marker, else the largest
    `{step}.pth.tar`), or None."""
    marker = os.path.join(ckpt_path, "latest")
    if os.path.isfile(marker):
        with open(marker) as f:
            return int(f.read().strip())
    steps = [int(name[:-len(".pth.tar")]) for name in os.listdir(ckpt_path)
             if name.endswith(".pth.tar") and name[:-len(".pth.tar")].isdigit()
             ] if os.path.isdir(ckpt_path) else []
    return max(steps) if steps else None


def restore_checkpoint(ckpt_path, state, restore_step, reset_optimizers=False):
    """Load `{ckpt_path}/{restore_step}.pth.tar` into `state` in place.
    Returns the step after which the restored run's batch stream began:
    `restore_step` itself with `reset_optimizers` (the aux -> shallow
    handoff: weights and epoch load, the optimizers, step and learning
    rates stay fresh), else the checkpoint's `stream_start`."""
    path = checkpoint_path(ckpt_path, restore_step)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no checkpoint {path}: the port reads the reference's .pth.tar format "
            f"(`python -m mixgantts_tpu.export` writes one from an orbax checkpoint)")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    missing = [k for k in WEIGHT_KEYS + (() if reset_optimizers else RESUME_KEYS)
               if k not in ckpt]
    if missing:
        raise ValueError(
            f"{path} lacks the keys {missing}: a checkpoint of epoch, G and D only (as "
            f"`python -m mixgantts_tpu.export` writes) restores only at the aux -> shallow "
            f"handoff (restore_step == total_step_aux), where the optimizers start fresh")
    load_reference_generator(state.model, ckpt["G"])
    state.discriminator.load_state_dict(ckpt["D"], strict=True)
    state.epoch = int(ckpt["epoch"])
    if reset_optimizers:
        return restore_step
    state.opt_g_fs2.load_state_dict(ckpt["optG_fs2"])
    state.opt_g.load_state_dict(ckpt["optG"])
    state.opt_d.load_state_dict(ckpt["optD"])
    state.step, state.lr_g, state.lr_d = int(ckpt["step"]), float(ckpt["lr_g"]), float(ckpt["lr_d"])
    rng = ckpt["rng"]
    state.generator.set_state(rng["generator"])
    torch.set_rng_state(rng["cpu"])
    for i, s in enumerate(rng["cuda"][:torch.cuda.device_count()]):
        torch.cuda.set_rng_state(s, i)
    return int(ckpt["stream_start"])
