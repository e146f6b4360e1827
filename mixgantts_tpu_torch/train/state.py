"""Train state (`mixgantts_tpu/train/state.py`): the generator and the
discriminator, the three optimizers, the per-epoch GAN learning rates, the
step and epoch counters, and the `torch.Generator` the steps draw their
diffusion randomness from.  The steps update it in place.  A state
replicated or sharded over a process mesh (`parallel.replicate_state`,
`parallel.shard_state`) holds the mesh and the partition specs."""

from dataclasses import dataclass

import torch
import torch.nn as nn

from .optim import Adam, build_fs2_optimizer, build_gan_optimizer


@dataclass
class TrainState:
    model: nn.Module            # MixGANTTS
    discriminator: nn.Module    # JCUDiscriminator
    opt_g_fs2: Adam             # aux mode's Noam-scheduled optimizer of G
    opt_g: Adam                 # naive and shallow modes' optimizer of G
    opt_d: Adam
    lr_g: float                 # per-epoch ExponentialLR values (`optim.exponential_lr`)
    lr_d: float
    step: int
    epoch: int
    generator: torch.Generator
    mesh: object = None         # parallel.Mesh once replicated or sharded over one
    specs: dict = None          # parallel.tp.partition_specs once sharded


def create_train_state(model, discriminator, train_config, model_config, restore_step=0,
                       generator=None):
    """The state of a run starting at `restore_step`, with fresh optimizers.
    `generator` defaults to one on the model's device, seeded 0.  (Dropout
    draws from torch's default generator, which has no per-call argument.)"""
    opt = train_config["optimizer"]
    k = opt.get("grad_acc_step", 1)
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device).manual_seed(0)
    return TrainState(
        model=model, discriminator=discriminator,
        opt_g_fs2=build_fs2_optimizer(model.parameters(), model_config, train_config),
        opt_g=build_gan_optimizer(model.parameters(), opt["betas"], opt["grad_clip_thresh"], k),
        opt_d=build_gan_optimizer(discriminator.parameters(), opt["betas"],
                                  opt["grad_clip_thresh"], k),
        lr_g=float(opt["init_lr_G"]), lr_d=float(opt["init_lr_D"]),
        step=int(restore_step), epoch=1, generator=generator)
