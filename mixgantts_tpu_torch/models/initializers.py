"""The JAX package's random initialisers, for models built from a seed.

The JAX package leaves most layers to flax's defaults; the port's layers
are torch modules, whose own defaults differ (kaiming-uniform weights of
variance 1 / (3 fan_in), uniform biases, N(0, 1) embedding tables).
`init_like_jax` redraws a model as the JAX package draws it:

- every convolution and linear weight (`nn.Conv1d`, `nn.Conv2d`,
  `nn.ConvTranspose1d`, `nn.Linear`): flax's `lecun_normal`, a normal of
  variance 1 / fan_in truncated at two standard deviations, where fan_in is
  `weight[0].numel()` in torch's layout: input channels x taps for a
  convolution or linear layer, and output channels x taps for a transposed
  convolution (whose flax kernel is [k, out, in]);
- every bias zero;
- every `nn.Embedding`: flax's `nn.Embed` default, N(0, 1 / features);
- then each module's `reset_like_jax(generator)`, where the JAX package
  names an initialiser (xavier-uniform `LinearNorm`s and attention
  projections, the relative position tables, the N(0, 1) phoneme table,
  the zero denoiser output, the discriminator's normal(0.02)).

Norms, position tables and buffers keep their constructed values (flax's
and torch's agree there).  The draws come from a `torch.Generator` (the
global one by default, so `torch.manual_seed` then a constructor gives one
model); they follow flax's distributions and cannot equal its draws.
"""

import math

import torch
import torch.nn as nn

TRUNCATED_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]
LAYERS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)


@torch.no_grad()
def lecun_normal_(weight, generator=None):
    """flax's `lecun_normal` in place, fan_in = weight[0].numel(): a normal
    truncated to [-2, 2] standard deviations, drawn by inverting its CDF
    (uniform over [erf(-sqrt 2), erf(sqrt 2)], then erfinv)."""
    std = weight[0].numel() ** -0.5 / TRUNCATED_STD
    edge = math.erf(math.sqrt(2.0))
    weight.uniform_(-edge, edge, generator=generator).erfinv_()
    return weight.mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


@torch.no_grad()
def embed_normal_(weight, generator=None):
    """flax's `nn.Embed` default in place: N(0, 1 / features)."""
    return nn.init.normal_(weight, std=weight.shape[-1] ** -0.5, generator=generator)


@torch.no_grad()
def init_like_jax(module, generator=None):
    """Draw every parameter of `module` as the JAX package draws it (see
    the module docstring).  Returns `module`."""
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            embed_normal_(m.weight, generator)
        elif isinstance(m, LAYERS):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    for m in module.modules():
        if hasattr(m, "reset_like_jax"):
            m.reset_like_jax(generator)
    return module
