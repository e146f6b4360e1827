"""Shared CLI plumbing (`mixgantts_tpu/cli/common.py`): config loading,
path-tag routing, model assembly, the generator checkpoint, and host
batches moved to the device.

Path routing as the reference: checkpoint and log directories take the
suffix `_naive` or `_shallow` (aux and shallow share), result directories
the exact model name, each with an optional extra path tag.
"""

import json
import os

import numpy as np
import torch

from ..config import NormStats, get_configs_of
from ..convert import load_reference_generator
from ..models.discriminator import JCUDiscriminator
from ..models.mixgantts import MixGANTTS
from ..utils.profiling import span


def route_paths(train_config, model, path_tag=""):
    train_tag = "naive" if model == "naive" else "shallow"
    tag = f"_{path_tag}" if path_tag else ""
    p = train_config["path"]
    p["ckpt_path"] = p["ckpt_path"] + f"_{train_tag}{tag}"
    p["log_path"] = p["log_path"] + f"_{train_tag}{tag}"
    p["result_path"] = p["result_path"] + f"_{model}{tag}"
    return train_config


def load_configs(args):
    preprocess_config, model_config, train_config = get_configs_of(args.dataset)
    if args.model == "shallow" and args.restore_step < train_config["step"]["total_step_aux"]:
        raise AssertionError("shallow training must restore from a finished aux checkpoint")
    route_paths(train_config, args.model, getattr(args, "path_tag", ""))
    return preprocess_config, model_config, train_config


def n_speakers_of(preprocess_config, model_config):
    """Speakers of the corpus (`speakers.json`); 1 for a single-speaker model."""
    if not model_config["multi_speaker"]:
        return 1
    path = os.path.join(preprocess_config["path"]["preprocessed_path"], "speakers.json")
    with open(path) as f:
        return len(json.load(f))


def build_model(mode, preprocess_config, model_config, device=None):
    """The generator of a mode, with the corpus's stats.json (placeholder
    stats where there is none) and speaker count, on `device` (default
    cuda)."""
    stats = NormStats.load_or_default(
        preprocess_config["path"]["preprocessed_path"],
        n_mels=preprocess_config["preprocessing"]["mel"]["n_mel_channels"])
    model = MixGANTTS.from_configs(
        mode, preprocess_config, model_config, stats,
        n_speakers=n_speakers_of(preprocess_config, model_config), device=device)
    return model, stats


def build_discriminator(preprocess_config, model_config, device=None):
    """The JCU discriminator of the configs, on `device` (default cuda)."""
    return JCUDiscriminator.from_configs(preprocess_config, model_config, device=device)


def param_count(module):
    return sum(p.numel() for p in module.parameters())


def restore_generator(model, ckpt_path, restore_step):
    """Load G from `{ckpt_path}/{restore_step}.pth.tar`, the reference's
    checkpoint format (a dict with "G", as `python -m mixgantts_tpu.export`
    writes from an orbax checkpoint)."""
    path = os.path.join(ckpt_path, f"{restore_step}.pth.tar")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no checkpoint {path}: the port reads the reference's .pth.tar "
            f"format (`python -m mixgantts_tpu.export` writes one from an "
            f"orbax checkpoint)")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_generator(model, ckpt["G"])


def model_batch_of(batch):
    """Strip host-only fields before handing a batch to the device."""
    return {k: v for k, v in batch.items() if k not in ("ids", "raw_texts")}


def to_device(batch, device):
    """A host batch's arrays as tensors on `device` (their numpy types;
    through pinned memory without blocking the host when it is a GPU).
    Host-only fields are dropped."""
    out = {}
    with span("data.to_device"):
        for k, v in model_batch_of(batch).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out
