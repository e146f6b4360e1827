"""What every driver shares: the cell, its configuration and traffic
found by name, seeds derived from `--seed`, the weights made from the
seed, the program under test built through its public entry points, and
the reference built beside it (the class the configuration names,
`reference_of`).

Nothing here imports the program at module level: a driver imports it
when it runs, so that a checkout without the program fails there.
"""

import importlib
import json
import os
import re
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "mixgantts_tpu")   # whole top-level module names


def log(*args):
    print("[bench]", *args, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(name):
    """(the BENCHMARK.json entry of cell `name`, its configuration file,
    its traffic file, the whole BENCHMARK.json)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT, configs[cell["config"]]["file"])
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    return cell, config, traffic, bench


def limits_of(cell_name):
    return load_json(HERE, "limits", cell_name + ".json")


def sub_seed(seed, *tags):
    """A 63-bit seed derived from the run's seed and `tags` (any ints or
    strings), stable across processes."""
    words = [int(seed) & (2 ** 64 - 1), int(seed) >> 64]
    for tag in tags:
        words += [int(tag)] if isinstance(tag, int) else [ord(c) for c in str(tag)]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0] >> 1)


def rng(seed, *tags):
    return np.random.default_rng(sub_seed(seed, *tags))


def forbidden_modules():
    """The modules loaded in this process whose top-level name is one of
    FORBIDDEN, compared whole (`mixgantts_tpu_torch` is not
    `mixgantts_tpu`)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# --- configurations -------------------------------------------------------------

# the self-test's tiny widths: plumbing only, on the CPU
TINY_MODEL = {"transformer": {"encoder_layer": 1, "encoder_hidden": 32, "decoder_layer": 1,
                              "decoder_hidden": 32, "conv_filter_size": 64,
                              "conv_kernel_size": 3},
              "denoiser": {"residual_layers": 2, "residual_channels": 16},
              "discriminator": {"n_channels": [8, 16, 32, 16, 1]},
              "variance_predictor": {"filter_size": 32},
              "variance_embedding": {"n_bins": 32},
              "max_seq_len": 128,
              "tpu": {"length_buckets": [64, 128], "phone_buckets": [8, 16, 32]}}
TINY_HIFIGAN = {"upsample_initial_channel": 64, "upsample_rates": [4, 2],
                "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
                "resblock_dilation_sizes": [[1, 3], [1, 3]]}
TINY_TRAFFIC = {"synth": {"batch": 2, "words": [2, 6], "phones_per_word": [1, 3],
                          "templates": 3, "sample_rate": 1.0},
                "train": {"batch": 2, "mel_frames": [20, 100], "frames_per_word": 10,
                          "pool": 4}}


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def tiny(config, traffic):
    """The configuration and traffic of the self-test: every width cut so
    that a run takes seconds on the CPU (the number of reverse steps and
    of speakers kept).  The traffic's sizes come from its own `tiny` key,
    else from TINY_TRAFFIC by its driver."""
    config = dict(config, model=_merge(config["model"], TINY_MODEL),
                  hifigan=_merge(config["hifigan"], TINY_HIFIGAN),
                  stats=dict(config["stats"], max_seq_len=128))
    sizes = traffic.get("tiny", TINY_TRAFFIC.get(traffic["driver"]))
    if sizes is None:
        raise ValueError(f"the self-test has no sizes for driver {traffic['driver']!r}: "
                         f"give the traffic file a 'tiny' key")
    return config, _merge({k: v for k, v in traffic.items() if k != "tiny"}, sizes)


def n_speakers(config):
    """The configuration's speaker count (`n_speakers`, 1 if not stated)."""
    return int(config.get("n_speakers", 1))


def ref_config(config):
    """The reference's view of a configuration file: the model section,
    with the symbol count, the mel channels, the speaker count and the
    training section."""
    return dict(config["model"], n_symbols=config["n_symbols"],
                n_mels=config["preprocess"]["preprocessing"]["mel"]["n_mel_channels"],
                n_speakers=n_speakers(config), train=config["train"])


def reference_of(config):
    """The reference generator class a configuration names under
    `reference` (`<module>.<class>` of `benchmark/reference/`; by default
    the shallow `acoustic.Generator`), checked against the configuration's
    mode and speaker embedder."""
    name = config.get("reference", "acoustic.Generator")
    if not re.fullmatch(r"[A-Za-z_]\w*\.[A-Za-z_]\w*", name):
        raise ValueError(f"reference {name!r}: give <module>.<class> of benchmark/reference/")
    module, cls = name.split(".")
    generator = getattr(importlib.import_module(f"{__package__}.reference.{module}"), cls)
    if generator.mode != config["mode"]:
        raise ValueError(f"configuration {config.get('name')!r} is in {config['mode']!r} mode; "
                         f"its reference {name} is in {generator.mode!r} mode")
    embedder = config["preprocess"]["preprocessing"].get("speaker_embedder", "none")
    if config["model"].get("multi_speaker") and embedder != "none":
        raise ValueError(f"speaker embedder {embedder!r}: the reference has the speaker "
                         f"table only (speaker_embedder 'none')")
    return generator


def reference_generator(config):
    """The configuration's reference generator, built on the current
    default device (the meta device for its shapes)."""
    return reference_of(config)(ref_config(config), config["stats"])


def frame_bucket(config, n_phones):
    """The frame axis a synthesis call of `n_phones` phone slots runs at:
    a budget of 16 frames a phone (at least 64), capped at max_seq_len, at
    the next length bucket."""
    m = config["model"]
    return bucket(min(m["max_seq_len"], max(64, n_phones * 16)), m["tpu"]["length_buckets"])


def bucket(n, buckets):
    return next((b for b in buckets if n <= b), n)


# --- weights ------------------------------------------------------------------------

def make_weights(shapes, config, seed, device):
    """Every tensor of a state dict ({key: (shape, dtype)}) drawn from the
    seed on `device` by one generator in one call: N(0, 1 / fan_in) for a
    weight of two or more axes (fan_in: one output row's size), N(0, 0.02^2)
    for a bias or a running mean, 1 + N(0, 0.02^2) for a norm's scale or a
    running variance, the sinusoid table for a position table, zero for a
    counter.  The duration predictor's last layer is set so that a phone
    lasts about `frames_per_phone` frames (the configuration's `assumed`)."""
    import torch
    from .reference.blocks import sinusoid_position_table

    floats = {k: s for k, (s, dt) in shapes.items() if dt.is_floating_point}
    total = sum(int(np.prod(s)) for s in floats.values())
    g = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for key, (shape, dtype) in shapes.items():
        if not dtype.is_floating_point:
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = int(np.prod(shape))
        w = flat[at:at + n].view(shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("position_enc"):
            w = torch.from_numpy(sinusoid_position_table(shape[1], shape[2]))[None].to(device)
        elif len(shape) >= 2:
            w = w * (n // shape[0]) ** -0.5
        elif leaf in ("weight", "gamma", "running_var"):   # a norm's scale (1-D weights)
            w = 1.0 + 0.02 * w
        else:
            w = 0.02 * w
        out[key] = w.to(dtype)
    last = "linguistic_encoder.duration_predictor.linear_layer."
    if last + "bias" in out:
        out[last + "weight"] = out[last + "weight"] * 0.3
        out[last + "bias"] = torch.full_like(out[last + "bias"],
                                             float(np.log(config["frames_per_phone"])))
    return out


def shapes_of(module):
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}


# --- the program under test, through its public entry points -------------------------

def stats_of(config):
    from mixgantts_tpu_torch.config import NormStats
    return NormStats(**config["stats"])


def build_vocoder(config, device):
    """`get_vocoder` on the configuration's HiFi-GAN, passed as the
    `config.json` of a directory of its own under TMPDIR, removed once read
    (no checkpoint: a random init that the caller replaces)."""
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    ckpt_dir = tempfile.mkdtemp(prefix="bench-hifigan-")
    try:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(config["hifigan"], f)
        return get_vocoder(config["model"], ckpt_dir=ckpt_dir, device=device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def program_synth(config, device, weights_seed):
    """(TTSPipeline, model, vocoder) of the program, with the weights made
    from the seed, and the reference-shaped weights they were loaded from."""
    import torch
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    from .reference.hifigan import HiFiGAN

    with torch.device("meta"):
        ref_g = reference_generator(config)
        ref_v = HiFiGAN(config["hifigan"])
    model = MixGANTTS.from_configs(config["mode"], config["preprocess"], config["model"],
                                   stats_of(config), n_speakers=n_speakers(config),
                                   device=device)
    vocoder = build_vocoder(config, device)
    weights = {"G": make_weights(shapes_of(ref_g), config, weights_seed, device),
               "V": make_weights(shapes_of(ref_v), config, sub_seed(weights_seed, "V"), device)}
    model.load_state_dict(weights["G"], strict=True)
    vocoder.generator.load_state_dict(weights["V"], strict=True)
    model.eval()
    vocoder.generator.eval()
    if device.type == "cpu":   # the CUDA path's operand type, in the plain versions
        model.diffusion.denoise_fn.stack_dtype = torch.bfloat16
        vocoder.generator.mrf_dtype = torch.bfloat16
    pipeline = TTSPipeline(model, vocoder, config["preprocess"], config["model"])
    return pipeline, model, vocoder, weights


def program_train(config, device, weights_seed, generator_seed, restore_step):
    """(train state, chunk_fn, G/D weights) of the program's shallow GAN
    step, built as the train CLI builds it, with the weights made from the
    seed.  Only a configuration whose reference the training reference
    trains (`reference/train_step.py`: shallow mode) is taken."""
    import torch
    from mixgantts_tpu_torch.models.discriminator import JCUDiscriminator
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.train import chunk_train_step, create_train_state, make_train_step
    from .reference.discriminator import JCUDiscriminator as RefD
    from .reference.train_step import TrainStep

    generator = reference_of(config)
    if generator is not TrainStep.trains:
        trained = TrainStep.trains
        raise ValueError(
            f"configuration {config.get('name')!r} ({config['mode']} mode, reference "
            f"{generator.__module__}.{generator.__name__}) has no training reference: "
            f"benchmark/reference/train_step.py trains {trained.mode} mode's "
            f"{trained.__module__}.{trained.__name__} only")
    rc = ref_config(config)
    with torch.device("meta"):
        ref_g = generator(rc, config["stats"])
        ref_d = RefD(rc["n_mels"], rc["denoiser"]["residual_channels"], rc["discriminator"])
    model = MixGANTTS.from_configs(config["mode"], config["preprocess"], config["model"],
                                   stats_of(config), n_speakers=n_speakers(config),
                                   device=device)
    disc = JCUDiscriminator.from_configs(config["preprocess"], config["model"], device=device)
    weights = {"G": make_weights(shapes_of(ref_g), config, weights_seed, device),
               "D": make_weights(shapes_of(ref_d), config, sub_seed(weights_seed, "D"), device)}
    model.load_state_dict(weights["G"], strict=True)
    disc.load_state_dict(weights["D"], strict=True)
    state = create_train_state(model, disc, config["train"], config["model"],
                               restore_step=restore_step,
                               generator=torch.Generator(device).manual_seed(generator_seed))
    step_fn = make_train_step(config["mode"], model, disc, config["model"], config["train"])
    return state, chunk_train_step(step_fn), weights


def device_info(device, count):
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}

