"""Train and eval steps (`mixgantts_tpu/train/step.py`), fp32.

Aux mode runs one generator forward and the reconstruction loss on the
Noam-scheduled optimizer.  Naive and shallow modes run the reference's
two-phase GAN step: (1) the discriminator is updated on the pairs of a
first generator forward, taken without gradients; (2) a second forward,
with fresh t, noise and dropout draws, goes through the updated
discriminator for the adversarial, reconstruction and feature-matching
losses, and G is updated.  Only phase 2 moves the PostNet's running
statistics, as the JAX step keeps only its second forward's.

The model and discriminator are in training mode for a step (dropout,
batch statistics) and go back to the mode they were in.  Randomness: t and
the diffusion noises come from `state.generator`, or from
`noise_overrides`, one `noise_override` dict per generator forward (keys in
`models/mixgantts.py`); dropout draws from torch's default generator.
"""

import contextlib
import warnings

import torch

from ..losses import LossConfig, generator_loss, get_adversarial_losses_fn

BATCH_MODEL_KEYS = (
    "speakers", "texts", "src_lens", "word_boundaries", "src_w_lens",
    "mels", "mel_lens", "attn_priors", "p_targets", "e_targets",
    "d_targets", "spker_embeds",
)


def _model_kwargs(batch):
    kw = {k: batch[k] for k in BATCH_MODEL_KEYS if k in batch}
    kw["max_mel_len"] = batch["mels"].shape[1]
    return kw


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


def _check_flags(mode, model_config):
    """The JAX package's checks of its opt-in step variants, which the
    port has not ported yet: those raise rather than run a plain step."""
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
    flag = "reuse_g_forward" if reuse_g else "reuse_aux_forward" if reuse_aux else None
    if flag and mode == "aux":
        warnings.warn(
            f"tpu.{flag} is inert for the aux phase (aux runs a single "
            f"forward per step); it will take effect in the GAN phase "
            f"of this schedule", stacklevel=3)
    elif flag:
        raise NotImplementedError(
            f"tpu.{flag} is not ported to PyTorch yet (ROADMAP item 5); "
            f"remove it to train with the two-forward GAN step")
    dtype = tpu_cfg.get("compute_dtype", "float32")
    if dtype != "float32":
        raise NotImplementedError(
            f"tpu.compute_dtype={dtype!r} in training is not ported to "
            f"PyTorch yet (ROADMAP item 5); the port trains in float32")


def _d_features(discriminator, out, spk):
    """D's (real, fake) feature pairs of a training forward: (x_t, x_{t-1})
    and (x_t, the posterior sample)."""
    t = out.diffusion_step
    real = discriminator(out.x_ts, out.x_t_prevs, spk, t)
    fake = discriminator(out.x_ts, out.x_t_prev_preds, spk, t)
    return real, fake


def make_train_step(mode, model, discriminator, model_config, train_config):
    """step_fn(state, batch, noise_overrides=None) -> metrics: one training
    step that updates `state` (parameters, optimizers, PostNet statistics,
    step) in place and returns the losses as scalar tensors on the model's
    device.  `batch` holds the model's inputs and targets as tensors on
    its device (`BATCH_MODEL_KEYS`; `mels` sets the frame axis)."""
    if model.mode != mode:
        raise ValueError(f"mode {mode!r} for a {model.mode!r} model")
    _check_flags(mode, model_config)
    loss_cfg = LossConfig.from_configs(mode, model_config, train_config)
    d_loss_fn, g_loss_fn = get_adversarial_losses_fn(loss_cfg.adv_loss_mode)
    diffusion = model.diffusion

    def g_forward(state, batch, noise, update_stats=True):
        return model(**_model_kwargs(batch), noise_override=noise,
                     generator=state.generator, update_stats=update_stats)

    if mode == "aux":

        def step_fn(state, batch, noise_overrides=None):
            (noise,) = noise_overrides or (None,)
            with _mode(model, True):
                out = g_forward(state, batch, noise)
                losses = generator_loss(loss_cfg, diffusion, out, batch["mels"],
                                        batch["p_targets"], batch["e_targets"], step=state.step)
                state.opt_g_fs2.zero_grad()
                losses["recon_loss"].backward()
                state.opt_g_fs2.step()
            zero = torch.zeros_like(losses["recon_loss"])
            metrics = dict(losses, total_loss=losses["recon_loss"], G_loss=losses["recon_loss"],
                           D_loss=zero, adv_loss=zero)
            state.step += 1
            return {k: v.detach() for k, v in metrics.items()}

        return step_fn

    def step_fn(state, batch, noise_overrides=None):
        noise1, noise2 = noise_overrides or (None, None)
        with _mode(model, True), _mode(discriminator, True):
            # phase 1: D on the pairs of a forward taken without gradients
            with torch.no_grad():
                out1 = g_forward(state, batch, noise1, update_stats=False)
            (real_c, real_u), (fake_c, fake_u) = _d_features(discriminator, out1,
                                                             out1.speaker_emb)
            r_loss, f_loss = d_loss_fn(real_c[-1], real_u[-1], fake_c[-1], fake_u[-1])
            D_loss = r_loss + f_loss
            state.opt_d.zero_grad()
            D_loss.backward()
            state.opt_d.step(state.lr_d)

            # phase 2: G through the updated D, on a fresh forward
            with _frozen(discriminator):
                out2 = g_forward(state, batch, noise2)
                (real_c, real_u), (fake_c, fake_u) = _d_features(discriminator, out2,
                                                                 out2.speaker_emb)
                adv_loss = g_loss_fn(fake_c[-1], fake_u[-1])
                losses = generator_loss(loss_cfg, diffusion, out2, batch["mels"],
                                        batch["p_targets"], batch["e_targets"],
                                        step=state.step, Ds=(real_c, real_u, fake_c, fake_u))
                G_loss = adv_loss + losses["recon_loss"] + losses["fm_loss"]
                state.opt_g.zero_grad()
                G_loss.backward()
            state.opt_g.step(state.lr_g)
        metrics = dict(losses, total_loss=D_loss + G_loss, D_loss=D_loss, G_loss=G_loss,
                       adv_loss=adv_loss)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_eval_step(mode, model, discriminator, model_config, train_config):
    """eval_fn(state, batch, generator=None, noise_override=None) -> the
    step's losses without updates: the training branch in eval mode (no
    dropout, the PostNet's running statistics)."""
    loss_cfg = LossConfig.from_configs(mode, model_config, train_config)
    d_loss_fn, g_loss_fn = get_adversarial_losses_fn(loss_cfg.adv_loss_mode)
    diffusion = model.diffusion

    def eval_fn(state, batch, generator=None, noise_override=None):
        with _mode(model, False), _mode(discriminator, False), torch.no_grad():
            out = model(**_model_kwargs(batch), noise_override=noise_override,
                        generator=generator if generator is not None else state.generator)
            if mode == "aux":
                losses = generator_loss(loss_cfg, diffusion, out, batch["mels"],
                                        batch["p_targets"], batch["e_targets"], step=state.step)
                zero = torch.zeros_like(losses["recon_loss"])
                losses.update(D_loss=zero, adv_loss=zero, G_loss=losses["recon_loss"],
                              total_loss=losses["recon_loss"])
                return losses
            (real_c, real_u), (fake_c, fake_u) = _d_features(discriminator, out,
                                                             out.speaker_emb)
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
