"""Shared helpers of the tests that hold the port's training path against
the JAX package's: the tiny training configurations (copied from
`tests/test_train_step.py` and `tests/test_model_forward.py`, whose
modules these tests do not import), models on both sides with the same
weights, batches and diffusion noise made with numpy, and dropout switched
off on both sides for value parity."""

import copy
import functools
import os
import zlib

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from mixgantts_tpu.config import NormStats
from mixgantts_tpu.models.diffusion import DiffusionSchedule
from mixgantts_tpu.models.discriminator import JCUDiscriminator as JJCUDiscriminator
from mixgantts_tpu.models.mixgantts import MixGANTTS as JMixGANTTS
from mixgantts_tpu_torch.convert import discriminator_state_dict
from mixgantts_tpu_torch.models.diffusion import GaussianDiffusion
from mixgantts_tpu_torch.models.discriminator import JCUDiscriminator
from mixgantts_tpu_torch.utils.logging import LOSS_KEYS
from torch_port_helpers import numpy_tree, t, torch_generator_like

TRAIN_CONFIG = {
    "optimizer": {
        "batch_size": 2, "batch_size_shallow": 2, "betas": [0.5, 0.9],
        "gamma": 0.999, "grad_clip_thresh": 1, "grad_acc_step": 1,
        "init_lr_G": 1e-4, "init_lr_D": 2e-4,
    },
    "optimizer_fs2": {
        "betas": [0.9, 0.98], "eps": 1e-9, "weight_decay": 0.0,
        "warm_up_step": 10, "anneal_steps": [100], "anneal_rate": 0.3,
    },
    "loss": {
        "adv_loss_mode": "lsgan", "noise_loss": "l1", "dur_loss": "mse",
        "pitch_loss": "l1", "lambda_d": 0.1, "lambda_p": 0.1,
        "lambda_e": 0.1, "lambda_fm": 10.0, "lambda_fm_shallow": 0.001,
    },
    "step": {"total_step_aux": 10, "total_step_naive": 10,
             "total_step_shallow": 10, "log_step": 5, "synth_step": 5,
             "val_step": 5, "save_step": 5},
    "aligner": {"helper_type": "dga", "ctc_step": 0, "ctc_weight_start": 1.0,
                "ctc_weight_end": 1.0, "guided_sigma": 0.4,
                "guided_lambda": 1.0, "guided_weight": 1.0},
}
MODEL_CONFIG = {
    "transformer": {"encoder_hidden": 32},
    "discriminator": {"n_layer": 3, "n_cond_layer": 2},
}
N_MELS, TIMESTEPS = 16, 4
MODES = ("aux", "naive", "shallow")


def train_config(helper="dga"):
    tc = copy.deepcopy(TRAIN_CONFIG)
    tc["aligner"]["helper_type"] = helper
    return tc


def tiny_model(mode, multi_speaker=False):
    stats = NormStats.default(n_mels=N_MELS)
    schedule = DiffusionSchedule.create(
        "vpsde", TIMESTEPS, 0.1, 40, 0.008, stats.spec_min, stats.spec_max)
    return JMixGANTTS(
        mode=mode, schedule=schedule, stats=stats,
        hidden=32, encoder_layers=1, encoder_heads=2, conv_kernel_size=3,
        decoder_layers=1, decoder_heads=2, conv_filter_size=64,
        max_seq_len=64, n_mels=N_MELS, n_bins=8, residual_channels=16,
        residual_layers=2, multi_speaker=multi_speaker, n_speakers=4,
    )


def tiny_disc(multi_speaker=False):
    return JJCUDiscriminator(n_mels=N_MELS, residual_channels=16,
                             n_channels=(8, 16, 32, 16, 1), multi_speaker=multi_speaker)


def tiny_batch(rng=0, B=2, P=6, W=3, T=12):
    """The JAX tests' training batch, as numpy arrays."""
    r = np.random.RandomState(rng)
    return dict(
        speakers=np.array([0, 1]),
        texts=r.randint(1, 50, (B, P)),
        src_lens=np.array([P, P - 2]),
        word_boundaries=np.array([[2, 2, 2], [2, 2, 0]]),
        src_w_lens=np.array([W, W - 1]),
        mels=r.randn(B, T, N_MELS).astype(np.float32),
        mel_lens=np.array([T, T - 4]),
        p_targets=r.randn(B, P).astype(np.float32),
        e_targets=r.randn(B, P).astype(np.float32),
        d_targets=np.array([[2, 2, 2, 2, 2, 2], [2, 2, 2, 2, 0, 0]]),
    )


def attn_priors(batch, seed=3):
    """A random [B, P, T] prior, normalised over phonemes."""
    B, P = batch["texts"].shape
    T = batch["mels"].shape[1]
    prior = np.random.RandomState(seed).uniform(0.05, 1.0, (B, P, T)).astype(np.float32)
    return prior / prior.sum(1, keepdims=True)


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_variables(multi_speaker):
    """The variables of the tiny shallow model, which has every parameter
    of the other modes (aux mode's are the same, naive mode's lack the
    decoder, mel_linear and PostNet): one init serves the three."""
    model = tiny_model("shallow", multi_speaker)
    batch = tiny_batch()
    T = batch["mels"].shape[1]
    variables = numpy_tree(jax.jit(model.init, static_argnames=("max_mel_len", "train"))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)}, **batch, max_mel_len=T, train=False))
    r = np.random.RandomState(5)
    out_proj = variables["params"]["denoiser"]["output_projection"]["conv"]
    out_proj["kernel"] = (r.randn(*out_proj["kernel"].shape) * 0.1).astype(np.float32)
    for bn in variables["batch_stats"]["postnet"].values():
        bn["mean"] = r.randn(*bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = r.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    x = np.zeros((2, T, N_MELS), np.float32)
    spk = np.zeros((2, model.hidden), np.float32) if multi_speaker else None
    d_params = numpy_tree(tiny_disc(multi_speaker).init(
        jax.random.PRNGKey(7), x, x, spk, np.zeros((2,), np.int32))["params"])
    return variables, d_params


def jax_setup(mode, multi_speaker=False):
    """(model, variables, disc, d_params) of the tiny JAX models (a speaker
    table of 4 and D's speaker projection when `multi_speaker`), numpy
    trees (callers must not modify them).  The denoiser's zero output
    projection is made random so the residual stack's gradients show, and
    the PostNet's running statistics random so eval-mode BatchNorm does."""
    variables, d_params = _jax_variables(multi_speaker)
    if mode == "naive":
        variables = {"params": {k: v for k, v in variables["params"].items()
                                if k not in ("decoder", "mel_linear", "postnet")}}
    return (tiny_model(mode, multi_speaker), variables, tiny_disc(multi_speaker), d_params)


def torch_disc_like(disc, d_params):
    port = JCUDiscriminator(
        n_mels=disc.n_mels, residual_channels=disc.residual_channels, n_layer=disc.n_layer,
        n_uncond_layer=disc.n_uncond_layer, n_cond_layer=disc.n_cond_layer,
        n_channels=disc.n_channels, kernel_sizes=disc.kernel_sizes, strides=disc.strides,
        multi_speaker=disc.multi_speaker,
        speaker_dim=d_params["spk_mlp"]["linear"]["kernel"].shape[0]
        if "spk_mlp" in d_params else 256, device="cpu")
    port.load_state_dict(discriminator_state_dict(d_params), strict=True)
    return port


def port_setup(mode, multi_speaker=False):
    """Fresh port models (G, D) with `jax_setup(mode)`'s weights."""
    model, variables, disc, d_params = jax_setup(mode, multi_speaker)
    return torch_generator_like(model, variables), torch_disc_like(disc, d_params)


def training_noise(mode, batch, seed):
    """One forward's injected diffusion randomness, numpy: aux mode's trace
    noises, else t and the three noises of the training branch."""
    r = np.random.RandomState(seed)
    shape = batch["mels"].shape
    if mode == "aux":
        return {"trace_noises": r.randn(TIMESTEPS, *shape).astype(np.float32)}
    return {"t": r.randint(0, TIMESTEPS, shape[0]),
            "x_t_noise": r.randn(*shape).astype(np.float32),
            "x_t_prev_noise": r.randn(*shape).astype(np.float32),
            "posterior_noise": r.randn(*shape).astype(np.float32)}


def jax_noise(noise):
    """The JAX model's `noise_override` (aux mode's trace noises travel by
    `patch_jax_trace` instead)."""
    return {k: v for k, v in noise.items() if k != "trace_noises"}


def torch_noise(noise):
    return {k: t(v) for k, v in noise.items()}


def patch_jax_trace(monkeypatch, noises):
    """Make `DiffusionSchedule.diffuse_trace` take its step noises from the
    iterator `noises` ([S, B, T, M] per call) instead of its rng."""
    noises = iter(noises)

    def diffuse_trace(self, rng, mel, mel_mask):
        step_noises = next(noises)
        maskf = mel_mask[..., None].astype(mel.dtype)
        trace = [jnp.clip(self.norm_spec(mel), -1.0, 1.0) * maskf]
        for i in range(self.num_timesteps):
            t_i = jnp.full((mel.shape[0],), i, dtype=jnp.int32)
            trace.append(self.diffuse(mel, t_i, step_noises[i]) * maskf)
        return jnp.stack(trace, axis=0)

    monkeypatch.setattr(DiffusionSchedule, "diffuse_trace", diffuse_trace)


def jax_dropout_off(monkeypatch, calls=None):
    """flax Dropout as the identity; with `calls` a list, record each
    call's (rate, shape) in it."""
    def call(self, inputs, deterministic=None, rng=None):
        if calls is not None:
            calls.append((float(self.rate), tuple(inputs.shape)))
        return inputs

    monkeypatch.setattr(flax.linen.Dropout, "__call__", call)


def port_dropout_off(*modules, calls=None):
    """p = 0 on every nn.Dropout of the modules; with `calls` a list, record
    each call's (rate, shape) in it (the rate the module was built with)."""
    for module in modules:
        for m in module.modules():
            if isinstance(m, torch.nn.Dropout):
                if calls is not None:
                    rate = m.p
                    m.register_forward_pre_hook(
                        lambda mod, args, rate=rate: calls.append((rate, tuple(args[0].shape))))
                m.p = 0.0


def jax_apply_kwargs(batch):
    kw = dict(batch)
    kw["max_mel_len"] = batch["mels"].shape[1]
    return kw


def shape_noise(shape):
    """Gaussian noise that is a fixed function of its shape alone (seeded
    by the shape), so that a jitted JAX function, traced once per shape,
    and the port draw the same values."""
    seed = zlib.crc32(repr(tuple(int(n) for n in shape)).encode())
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def patch_trace_by_shape(monkeypatch):
    """On both sides, aux mode's diffuse trace takes its step noises
    [S, B, T, M] from `shape_noise` instead of a random stream: the JAX
    package's `DiffusionSchedule.diffuse_trace` and the port's
    `GaussianDiffusion.diffuse_trace`."""
    def jax_trace(self, rng, mel, mel_mask):
        step_noises = shape_noise((self.num_timesteps,) + tuple(mel.shape))
        maskf = mel_mask[..., None].astype(mel.dtype)
        trace = [jnp.clip(self.norm_spec(mel), -1.0, 1.0) * maskf]
        for i in range(self.num_timesteps):
            t_i = jnp.full((mel.shape[0],), i, dtype=jnp.int32)
            trace.append(self.diffuse(mel, t_i, step_noises[i]) * maskf)
        return jnp.stack(trace, axis=0)

    port_trace = GaussianDiffusion.diffuse_trace

    def torch_trace(self, mel, mel_mask, generator=None, noises=None):
        noises = torch.from_numpy(shape_noise((self.num_timesteps,) + tuple(mel.shape)))
        return port_trace(self, mel, mel_mask, noises=noises.to(mel.device))

    monkeypatch.setattr(DiffusionSchedule, "diffuse_trace", jax_trace)
    monkeypatch.setattr(GaussianDiffusion, "diffuse_trace", torch_trace)


def cli_workspace(root, n_utts=6):
    """test_cli.py's workspace under `root`: a corpus of `n_utts` sine-tone
    utterances preprocessed by the JAX `Preprocessor`, a two-word lexicon,
    and config/TestCorpus/*.yaml (TINY_MODEL_YAML, TINY_TRAIN_YAML with
    output paths under `root/output`)."""
    from mixgantts_tpu.data.preprocessor import Preprocessor
    from test_cli import TINY_MODEL_YAML, TINY_TRAIN_YAML
    from test_data_pipeline import PREPROCESS_CONFIG, make_corpus

    make_corpus(root, n_utts=n_utts)
    pre = copy.deepcopy(PREPROCESS_CONFIG)
    pre["dataset"] = "TestCorpus"
    pre["path"] = {"corpus_path": root, "lexicon_path": os.path.join(root, "lexicon.txt"),
                   "raw_path": os.path.join(root, "raw_data"),
                   "preprocessed_path": os.path.join(root, "preprocessed")}
    with open(pre["path"]["lexicon_path"], "w") as f:
        f.write("hello HH AH0 L OW1\nworld W ER1 L D\n")
    train = copy.deepcopy(TINY_TRAIN_YAML)
    train["path"] = {k: os.path.join(root, "output", k[:-5], "TestCorpus")
                     for k in ("ckpt_path", "log_path", "result_path")}
    mc = copy.deepcopy(TINY_MODEL_YAML)
    cfg_dir = os.path.join(root, "config", "TestCorpus")
    os.makedirs(cfg_dir, exist_ok=True)
    for name, cfg in (("preprocess.yaml", pre), ("model.yaml", mc), ("train.yaml", train)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.dump(cfg, f)
    Preprocessor(pre, mc, train).build_from_path()


def jit_generator_init(monkeypatch):
    """The JAX MixGANTTS's `init` jitted: the JAX CLI's `create_train_state`
    and the export CLI's initialise the generator op by op, ~30 s on the
    CPU, where one jitted init of the same function and keys takes ~9."""
    plain = flax.linen.Module.init

    def init(self, rngs, *args, **kwargs):
        static = {k: kwargs.pop(k) for k in ("max_mel_len", "train") if k in kwargs}
        return jax.jit(lambda r, a, kw: plain(self, r, *a, **kw, **static))(rngs, args, kwargs)

    monkeypatch.setattr(JMixGANTTS, "init", init)


def recording(fn, out):
    """fn, appending a host copy of each call's result to `out` (the JAX
    CLI donates its state's buffers to the train step)."""
    def wrapped(*args, **kwargs):
        result = fn(*args, **kwargs)
        out.append(jax.device_get(result))
        return result
    return wrapped


def recording_losses(loss_message, out):
    """`loss_message`, appending each call's (step, {loss key: float}) to
    `out`: the unrounded metrics behind a log line."""
    def wrapped(step, total_step, losses):
        out.append((step, {k: float(losses[k]) for k in LOSS_KEYS}))
        return loss_message(step, total_step, losses)
    return wrapped
