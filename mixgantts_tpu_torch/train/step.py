"""Train and eval steps (`mixgantts_tpu/train/step.py`), and
`chunk_train_step`, k steps over a segment of stacked batches.

Aux mode runs one generator forward and the reconstruction loss on the
Noam-scheduled optimizer.  Naive and shallow modes run the reference's
two-phase GAN step: (1) the discriminator is updated on the pairs of a
first generator forward, taken without gradients; (2) a second forward,
with fresh t, noise and dropout draws, goes through the updated
discriminator for the adversarial, reconstruction and feature-matching
losses, and G is updated.  Only phase 2 moves the PostNet's running
statistics, as the JAX step keeps only its second forward's.

The JAX package's opt-in variants (model.yaml `tpu`):
- `reuse_g_forward` (naive, shallow): one generator forward with autograd
  on; D trains on its detached pairs, then the G losses go through the
  updated D and back through that forward's graph (the JAX step's `vjp`
  pullback).  D and G see the same t, noise and dropout draws.
- `reuse_aux_forward` (shallow): one `aux_only` forward of the aux stack
  with autograd on; the diffusion branch runs on its detached stage
  without gradients for the D phase, then on the live stage for the G
  phase, with its own t and noise each time, so one backward gives the
  denoiser's gradients and the aux stack's (through the losses on its own
  outputs).
- `compute_dtype: bfloat16`: mixed precision as the JAX step computes it.
  The parameters, both Adam moments, the PostNet's running statistics,
  the gradients, clipping and the losses stay fp32.  The JAX step casts
  every parameter and the batch's floats to bf16 and lets promotion pick
  each op's type, and its fp32 masks, tables and step embeddings promote
  almost all of it back to fp32.  The port follows that promotion: G runs
  in fp32 on bf16-rounded copies of its parameters, except the modules
  whose input stays bf16 in JAX, which run in bf16 (the first phoneme
  self-attention's q, k, v projections on the bf16 phoneme embedding, and
  the speaker embedding and the denoiser's speaker projections:
  `G_LOWERED`, and each `speaker_projection`); D runs in bf16,
  except its step MLP and the conditional convolutions after the step is
  added, which run in fp32 on rounded copies (`D_ROUNDED`).  The copies
  are made inside the autograd graph, so the gradients reach the fp32
  masters rounded to bf16, as `jax.grad` of the cast rounds them.  The
  batch's `mels`, `p_targets`, `e_targets`, `attn_priors` and
  `spker_embeds` are rounded to bf16 for the forward, so the pitch and
  energy targets are bucketized as the JAX step bucketizes them; D's
  arguments are cast to bf16; the outputs go back to fp32 before the
  losses, which read the batch's own fp32 targets.

The model and discriminator are in training mode for a step (dropout,
batch statistics) and go back to the mode they were in.  Randomness: t and
the diffusion noises come from `state.generator`, or from
`noise_overrides`, one `noise_override` dict per diffusion branch (two for
the plain GAN step and `reuse_aux_forward`, one for aux mode and
`reuse_g_forward`; keys in `models/mixgantts.py`); dropout draws from
torch's default generator.

Inside `parallel.shard_train_step` (a mesh active) the same step is the
sharded one: the gradients are averaged over the data ranks between each
`backward()` and its optimizer's update, the losses' masked means and
the PostNet's statistics are global-batch ones, the draws are the global
batch's rows, and the tensor-parallel layers run their collectives.
"""

import contextlib
import warnings

import torch

from ..losses import LossConfig, generator_loss, get_adversarial_losses_fn
from ..parallel.collectives import average_gradients
from ..utils.profiling import span
from ..utils.tools import cast_param, compute_dtype

BATCH_MODEL_KEYS = (
    "speakers", "texts", "src_lens", "word_boundaries", "src_w_lens",
    "mels", "mel_lens", "attn_priors", "p_targets", "e_targets",
    "d_targets", "spker_embeds",
)
# the batch's floating-point entries, which the JAX step's `_cast_floats` casts
FLOAT_BATCH_KEYS = ("mels", "p_targets", "e_targets", "attn_priors", "spker_embeds")
# G's submodules that the JAX step computes in bf16 (their input is bf16);
# the rest of G computes in fp32, as JAX's promotion makes it
G_LOWERED = tuple(f"linguistic_encoder.phoneme_encoder.attn_layers.0.conv_{x}"
                  for x in "qkv") + ("speaker_emb",)
# D's submodules that the JAX step's promotion computes in fp32: the step
# MLP on the fp32 sinusoid, and the convolutions after its sum
D_ROUNDED = ("mlp", "cond_conv_block")


def model_kwargs(batch):
    """The generator's keyword arguments of a batch of tensors: its
    `BATCH_MODEL_KEYS`, and `max_mel_len` from the frame axis of `mels`."""
    kw = {k: batch[k] for k in BATCH_MODEL_KEYS if k in batch}
    kw["max_mel_len"] = batch["mels"].shape[1]
    return kw


def tree_map(fn, tree):
    """fn on every tensor of a (nested) tuple, NamedTuple, list or dict;
    everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def cast_floats(tree, dtype):
    """Every floating-point tensor of `tree` in `dtype`."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def round_floats(tree, dtype):
    """Every floating-point tensor of `tree` rounded to `dtype`, in its own
    type."""
    return tree_map(lambda x: x.to(dtype).to(x.dtype) if x.is_floating_point() else x, tree)


class MixedForward:
    """Calls `module` on copies of its parameters cast by `cast_param`
    (rounded inside the submodules named in `rounded` and outside those in
    `lowered`, else in `dtype`), made inside the autograd graph
    (`torch.func.functional_call`).  Buffers are the module's own, so
    BatchNorm's running statistics stay fp32 and move in place.  With dtype
    fp32 it is the module itself."""

    def __init__(self, module, dtype, rounded=(), lowered=()):
        self.module, self.dtype, self.rounded, self.lowered = module, dtype, rounded, lowered

    def __call__(self, *args, **kwargs):
        if self.dtype == torch.float32:
            return self.module(*args, **kwargs)
        params = {name: cast_param(name, p, self.dtype, self.rounded, self.lowered)
                  for name, p in self.module.named_parameters()}
        return torch.func.functional_call(self.module, params, args, kwargs)


@contextlib.contextmanager
def _mode(module, training):
    was = module.training
    module.train(training)
    try:
        yield
    finally:
        module.train(was)


@contextlib.contextmanager
def _frozen(module):
    """The module's parameters take no gradient inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _update(opt, lr=None):
    """The optimizer's step on the gradients averaged over the data ranks
    (`parallel.collectives.average_gradients`; nothing to average on one
    device)."""
    with span("train.update"):
        average_gradients(opt.params)
        opt.step(lr)


def _backward(loss):
    with span("train.backward"):
        loss.backward()


def _check_flags(mode, model_config):
    """The JAX package's checks of its opt-in step variants (conflicts
    raise; a GAN-only flag is inert in aux mode and warns, since one
    model.yaml drives the aux phase and the GAN phase after it), and the
    port's own on `compute_dtype` (`tools.compute_dtype`: float32 or
    bfloat16, where the JAX package takes any floating dtype); returns
    (reuse_g, reuse_aux, compute dtype)."""
    tpu_cfg = model_config.get("tpu", {}) or {}
    reuse_g = bool(tpu_cfg.get("reuse_g_forward", False))
    reuse_aux = bool(tpu_cfg.get("reuse_aux_forward", False))
    if reuse_g and reuse_aux:
        raise ValueError(
            "tpu.reuse_g_forward and tpu.reuse_aux_forward are mutually "
            "exclusive (reuse_g_forward already shares the whole forward)")
    if reuse_aux and mode == "naive":
        raise ValueError(
            "tpu.reuse_aux_forward only applies to shallow training "
            "(naive mode never has a frozen aux stack to share); use "
            "tpu.reuse_g_forward to share the whole forward instead")
    if mode == "aux" and (reuse_g or reuse_aux):
        flag = "reuse_g_forward" if reuse_g else "reuse_aux_forward"
        warnings.warn(
            f"tpu.{flag} is inert for the aux phase (aux runs a single "
            f"forward per step); it will take effect in the GAN phase "
            f"of this schedule", stacklevel=3)
    return reuse_g, reuse_aux, compute_dtype(model_config)


def _d_features(d_apply, out, detach=False):
    """D's (real, fake) feature pairs of a training forward: (x_t, x_{t-1})
    and (x_t, the posterior sample), on detached copies with `detach`."""
    x_ts, x_t_prevs, x_t_prev_preds, spk = out.x_ts, out.x_t_prevs, out.x_t_prev_preds, \
        out.speaker_emb
    if detach:
        x_ts, x_t_prevs, x_t_prev_preds, spk = tree_map(
            torch.Tensor.detach, (x_ts, x_t_prevs, x_t_prev_preds, spk))
    t = out.diffusion_step
    return d_apply(x_ts, x_t_prevs, spk, t), d_apply(x_ts, x_t_prev_preds, spk, t)


def make_train_step(mode, model, discriminator, model_config, train_config):
    """step_fn(state, batch, noise_overrides=None) -> metrics: one training
    step that updates `state` (parameters, optimizers, PostNet statistics,
    step) in place and returns the losses as scalar tensors on the model's
    device.  `batch` holds the model's inputs and targets as tensors on
    its device (`BATCH_MODEL_KEYS`; `mels` sets the frame axis)."""
    if model.mode != mode:
        raise ValueError(f"mode {mode!r} for a {model.mode!r} model")
    reuse_g, reuse_aux, dtype = _check_flags(mode, model_config)
    mixed = dtype != torch.float32
    loss_cfg = LossConfig.from_configs(mode, model_config, train_config)
    d_loss_fn, g_loss_fn = get_adversarial_losses_fn(loss_cfg.adv_loss_mode)
    diffusion = model.diffusion
    speaker_projections = tuple(name for name, _ in model.named_modules()
                                if name.endswith("speaker_projection"))
    g_call = MixedForward(model, dtype, rounded=("",), lowered=G_LOWERED + speaker_projections)
    d_call = MixedForward(discriminator, dtype, rounded=D_ROUNDED)

    def g_forward(state, batch, noise, update_stats=True, aux_only=False, aux_reuse=None):
        with span("train.forward"):
            if mixed:
                batch = {k: round_floats(v, dtype) if k in FLOAT_BATCH_KEYS else v
                         for k, v in batch.items()}
                aux_reuse = round_floats(aux_reuse, dtype)
            out = g_call(**model_kwargs(batch), noise_override=noise, generator=state.generator,
                         update_stats=update_stats, aux_only=aux_only, aux_reuse=aux_reuse)
            return cast_floats(out, torch.float32) if mixed else out

    def d_apply(*args):
        if mixed:
            return cast_floats(d_call(*cast_floats(args, dtype)), torch.float32)
        return discriminator(*args)

    def recon_losses(state, batch, out, Ds=None):
        return generator_loss(loss_cfg, diffusion, out, batch["mels"], batch["p_targets"],
                              batch["e_targets"], step=state.step, Ds=Ds)

    if mode == "aux":

        def step_fn(state, batch, noise_overrides=None):
            (noise,) = noise_overrides or (None,)
            with span("train.step"), _mode(model, True):
                out = g_forward(state, batch, noise)
                with span("train.losses"):
                    losses = recon_losses(state, batch, out)
                state.opt_g_fs2.zero_grad()
                _backward(losses["recon_loss"])
                _update(state.opt_g_fs2)
            zero = torch.zeros_like(losses["recon_loss"])
            metrics = dict(losses, total_loss=losses["recon_loss"], G_loss=losses["recon_loss"],
                           D_loss=zero, adv_loss=zero)
            state.step += 1
            return {k: v.detach() for k, v in metrics.items()}

        return step_fn

    def d_phase(state, out):
        """D's update on the detached pairs of `out`; returns D's loss."""
        with span("train.d_phase"):
            (real_c, real_u), (fake_c, fake_u) = _d_features(d_apply, out, detach=True)
            with span("train.losses"):
                r_loss, f_loss = d_loss_fn(real_c[-1], real_u[-1], fake_c[-1], fake_u[-1])
                D_loss = r_loss + f_loss
            state.opt_d.zero_grad()
            _backward(D_loss)
            _update(state.opt_d, state.lr_d)
            return D_loss

    def g_phase(state, batch, out):
        """G's losses through the (updated, frozen) D, G's backward and
        update; returns (losses, adv_loss, G_loss)."""
        with span("train.g_phase"):
            with _frozen(discriminator):
                (real_c, real_u), (fake_c, fake_u) = _d_features(d_apply, out)
                with span("train.losses"):
                    adv_loss = g_loss_fn(fake_c[-1], fake_u[-1])
                    losses = recon_losses(state, batch, out, Ds=(real_c, real_u, fake_c, fake_u))
                    G_loss = adv_loss + losses["recon_loss"] + losses["fm_loss"]
                state.opt_g.zero_grad()
                _backward(G_loss)
            _update(state.opt_g, state.lr_g)
            return losses, adv_loss, G_loss

    def gan_step(state, batch, noise_overrides):
        if reuse_g:
            (noise,) = noise_overrides or (None,)
            out = g_forward(state, batch, noise)
            D_loss = d_phase(state, out)
            return (D_loss,) + g_phase(state, batch, out)
        noise1, noise2 = noise_overrides or (None, None)
        if reuse_aux:
            stage = g_forward(state, batch, None, aux_only=True)
            with torch.no_grad():   # D's branch records no graph on the live stage
                out1 = g_forward(state, batch, noise1, aux_reuse=stage)
            D_loss = d_phase(state, out1)
            return (D_loss,) + g_phase(
                state, batch, g_forward(state, batch, noise2, aux_reuse=stage))
        # phase 1: D on the pairs of a forward taken without gradients
        with torch.no_grad():
            out1 = g_forward(state, batch, noise1, update_stats=False)
        D_loss = d_phase(state, out1)
        # phase 2: G through the updated D, on a fresh forward
        return (D_loss,) + g_phase(state, batch, g_forward(state, batch, noise2))

    def step_fn(state, batch, noise_overrides=None):
        with span("train.step"):
            with _mode(model, True), _mode(discriminator, True):
                D_loss, losses, adv_loss, G_loss = gan_step(state, batch, noise_overrides)
            metrics = dict(losses, total_loss=D_loss + G_loss, D_loss=D_loss, G_loss=G_loss,
                           adv_loss=adv_loss)
            state.step += 1
            return {k: v.detach() for k, v in metrics.items()}

    return step_fn


def chunk_train_step(step_fn):
    """chunk_fn(state, batches) -> metrics: k train steps, in order, over
    batches stacked on a leading [k] axis (a dict of [k, B, ...] tensors),
    returning each metric stacked on [k].  The steps queue on the device
    with no host synchronisation between them, so the caller reads a
    segment's metrics with one copy to the host.  k chunked steps leave
    exactly the state that k sequential calls leave: the same step on the
    same values, drawing from the same random streams."""

    def chunk_fn(state, batches):
        k = next(iter(batches.values())).shape[0]
        metrics = [step_fn(state, {key: v[j] for key, v in batches.items()})
                   for j in range(k)]
        return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}

    return chunk_fn


def make_eval_step(mode, model, discriminator, model_config, train_config):
    """eval_fn(state, batch, generator=None, noise_override=None) -> the
    step's losses without updates: the training branch in eval mode (no
    dropout, the PostNet's running statistics)."""
    loss_cfg = LossConfig.from_configs(mode, model_config, train_config)
    d_loss_fn, g_loss_fn = get_adversarial_losses_fn(loss_cfg.adv_loss_mode)
    diffusion = model.diffusion

    def eval_fn(state, batch, generator=None, noise_override=None):
        with _mode(model, False), _mode(discriminator, False), torch.no_grad():
            out = model(**model_kwargs(batch), noise_override=noise_override,
                        generator=generator if generator is not None else state.generator)
            if mode == "aux":
                losses = generator_loss(loss_cfg, diffusion, out, batch["mels"],
                                        batch["p_targets"], batch["e_targets"], step=state.step)
                zero = torch.zeros_like(losses["recon_loss"])
                losses.update(D_loss=zero, adv_loss=zero, G_loss=losses["recon_loss"],
                              total_loss=losses["recon_loss"])
                return losses
            (real_c, real_u), (fake_c, fake_u) = _d_features(discriminator, out)
            r_loss, f_loss = d_loss_fn(real_c[-1], real_u[-1], fake_c[-1], fake_u[-1])
            adv_loss = g_loss_fn(fake_c[-1], fake_u[-1])
            losses = generator_loss(loss_cfg, diffusion, out, batch["mels"], batch["p_targets"],
                                    batch["e_targets"], step=state.step,
                                    Ds=(real_c, real_u, fake_c, fake_u))
            G_loss = adv_loss + losses["recon_loss"] + losses["fm_loss"]
            losses.update(D_loss=r_loss + f_loss, adv_loss=adv_loss, G_loss=G_loss,
                          total_loss=r_loss + f_loss + G_loss)
            return losses

    return eval_fn
