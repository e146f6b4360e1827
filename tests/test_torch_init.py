"""A model the port builds from a seed draws every parameter as the JAX
package draws it (`models/initializers.py::init_like_jax`, applied by the
constructors of the generator, the discriminator, HiFi-GAN and MelGAN).

SEEDS inits of a small JAX model, bridged to the port's names and layouts
(`mixgantts_tpu_torch.convert`), against SEEDS of the port's model built
after `torch.manual_seed(seed)`, pooled per parameter (and buffer):

- what the JAX init sets to constants (zero biases, norms, position
  tables, running statistics) the port sets to the same constants;
- every other parameter has, pooled over the seeds, its std within 12% of
  JAX's (25% under 1024 values), its mean within 0.1 std of JAX's, and its
  max|x| / std within 25% of JAX's, which tells a uniform (sqrt 3), a
  normal truncated at two std (2 / 0.88) and a normal (above 3) apart;
  the tests of whole models, whose layers are small, take these bars
  calibrated to the number of values (`calibrated_bars`).

The generator in aux, naive and shallow, each with one speaker and with
several (a speaker table, or a projection of external embeddings); the
discriminator with and without its speaker MLP; HiFi-GAN, as built
(`torch_default`: the constructor on torch's default generator) and
redrawn by `init_like_jax` from an explicit `torch.Generator`
(`jax_init`); MelGAN.  A comparison that draws with torch's own layer
defaults instead fails every drawn weight (`test_torch_defaults_fail`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizon_init_witness_torch import torch_default
from mixgantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from mixgantts_tpu.models.melgan import MelGANGenerator as JMelGAN
from mixgantts_tpu_torch.convert import (
    discriminator_state_dict, generator_state_dict, hifigan_state_dict, melgan_state_dict,
)
from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator
from mixgantts_tpu_torch.models.initializers import init_like_jax
from mixgantts_tpu_torch.models.melgan import MelGANGenerator
from test_vocoder import SMALL_CONFIG
from torch_port_helpers import (
    SPK_DIM, numpy_tree, speaker_batch, text_batch, tiny_model,
    torch_generator_like,
)
from torch_train_helpers import N_MELS, tiny_disc, torch_disc_like

SEEDS = 16


def as_numpy(state):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float64)
            for k, v in state.items()}


def mismatches(jax_states, port_states, calibrated=False):
    """The parameters whose pooled draws differ from JAX's (see the module
    docstring), and the number compared as drawn; `calibrated` takes the
    bars of the model tests (`calibrated_bars`)."""
    assert sorted(jax_states[0]) == sorted(port_states[0])
    bad, drawn = [], 0
    for name in jax_states[0]:
        j = np.stack([s[name] for s in jax_states])
        p = np.stack([s[name] for s in port_states])
        assert j.shape == p.shape, name
        if (j == j[:1]).all():   # set, not drawn
            if not np.allclose(p, j, rtol=1e-6, atol=1e-7):
                bad.append(name)
            continue
        drawn += 1
        sj, sp = j.std(), p.std()
        ok = abs(sp / sj - 1) < (0.12 if j.size >= 1024 else 0.25)
        if j.size >= 1024:
            mean_bar, tail = calibrated_bars(j.size) if calibrated else (0.1, np.max)
            tail_j, tail_p = tail(np.abs(j)) / sj, tail(np.abs(p)) / sp
            ok = (ok and abs(p.mean() - j.mean()) < mean_bar * sj
                  and 0.8 < tail_p / tail_j < 1.25)
        if not ok:
            bad.append(name)
    return bad, drawn


def calibrated_bars(n):
    """The bar on the means (in std) and the tail statistic of the model
    tests, for n pooled values a side.  Their layers are small, so they take
    the mean within 0.1 std or within 4 standard errors of the difference
    of two means (4 sqrt(2 / n) std) where that is wider, and the tail as
    the 99.9th percentile of |x| (uniform 1.73 std, a normal truncated at
    two std 2.26, a normal 3.29) instead of the max, which over a few
    thousand values of a normal table spreads from 3.1 to 4.0 std.  At
    1,024 values 0.1 std is 2.3 standard errors, a bar that 2% of the
    parameters that do draw alike would fail."""
    return max(0.1, 4 * (2 / n) ** 0.5), lambda a: np.quantile(a, 0.999)


def seeded(build):
    """The port's states of `build()` after torch.manual_seed(seed), for
    every seed."""
    states = []
    for seed in range(SEEDS):
        torch.manual_seed(seed)
        states.append(as_numpy(build().state_dict()))
    return states


def hifigan_states():
    module = JHiFiGAN.from_config(SMALL_CONFIG)
    jinit = jax.jit(lambda key: module.init(key, jnp.zeros((1, 16, SMALL_CONFIG["num_mels"]))))
    return [as_numpy(hifigan_state_dict(numpy_tree(jinit(jax.random.PRNGKey(seed))["params"])))
            for seed in range(SEEDS)]


@pytest.mark.parametrize("init", ["jax_init", "torch_default"])
def test_witness_reinitialises_hifigan_like_the_jax_package(init):
    """HiFi-GAN as its constructor draws it (torch's default generator), and
    redrawn by `init_like_jax` from a `torch.Generator` of the seed, as
    `tests/horizon_init_witness_torch.py`'s vocoder."""
    port_states = []
    for seed in range(SEEDS):
        torch.manual_seed(seed + SEEDS)
        gen = HiFiGANGenerator.from_config(SMALL_CONFIG, device="cpu")
        if init == "jax_init":
            init_like_jax(gen, torch.Generator().manual_seed(seed))
        port_states.append(as_numpy(gen.state_dict()))
    bad, drawn = mismatches(hifigan_states(), port_states)
    assert drawn >= 10
    assert bad == []


def test_torch_defaults_fail():
    """The comparison tells torch's layer defaults (kaiming-uniform weights,
    uniform biases; the witness's `torch_default`) from the JAX package's:
    every parameter fails it."""
    jax_states = hifigan_states()
    bad, _ = mismatches(jax_states, [
        as_numpy(torch_default(HiFiGANGenerator.from_config(SMALL_CONFIG, device="cpu"),
                               seed).state_dict()) for seed in range(SEEDS)])
    assert len(bad) == len(jax_states[0])


# speakers in the table of the multi-speaker generators: 64 x hidden 32
# values a seed, so that the pooled mean bar (0.1 std) is ~13 standard
# errors of the pooled difference (a table of 3 speakers pools 1,536
# values, where the bar is 2.8 standard errors)
TABLE_SPEAKERS = 64
GENERATOR_CASES = [(mode, speakers) for mode in ("aux", "naive", "shallow")
                   for speakers in ("one", "none" if mode != "naive" else "DeepSpeaker")]


@pytest.mark.parametrize("mode,speakers", GENERATOR_CASES)
def test_generator_draws_like_the_jax_package(mode, speakers):
    """`MixGANTTS` in each mode, with one speaker, or a table of
    TABLE_SPEAKERS ("none"), or a projection of SPK_DIM-wide external
    embeddings ("DeepSpeaker")."""
    model = tiny_model(mode)
    batch = text_batch()
    if speakers != "one":
        model = model.clone(multi_speaker=True, n_speakers=TABLE_SPEAKERS,
                            embedder_type=speakers, external_speaker_dim=SPK_DIM)
        batch = speaker_batch(batch, speakers)
    init = jax.jit(model.init, static_argnames=("max_mel_len", "train"))

    def jax_state(seed):
        variables = numpy_tree(init(
            {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(SEEDS + seed),
             "diffusion": jax.random.PRNGKey(2 * SEEDS + seed)},
            speakers=batch["speakers"], texts=batch["texts"], src_lens=batch["src_lens"],
            word_boundaries=batch["word_boundaries"], src_w_lens=batch["src_w_lens"],
            spker_embeds=batch.get("spker_embeds"), max_mel_len=32, train=False))
        return as_numpy(generator_state_dict(variables["params"],
                                             variables.get("batch_stats", {})))

    bad, drawn = mismatches([jax_state(seed) for seed in range(SEEDS)],
                            seeded(lambda: torch_generator_like(model)), calibrated=True)
    assert drawn >= 40
    assert bad == []


@pytest.mark.parametrize("multi_speaker", [False, True])
def test_discriminator_draws_like_the_jax_package(multi_speaker):
    disc = tiny_disc(multi_speaker)
    r = np.random.RandomState(0)
    x_t, x_prev = (r.randn(2, 13, N_MELS).astype(np.float32) for _ in range(2))
    spk = r.randn(2, 32).astype(np.float32) if multi_speaker else None
    init = jax.jit(lambda key: disc.init(key, x_t, x_prev, spk, np.array([0, 3])))
    params = [numpy_tree(init(jax.random.PRNGKey(seed))["params"]) for seed in range(SEEDS)]
    bad, drawn = mismatches([as_numpy(discriminator_state_dict(p)) for p in params],
                            seeded(lambda: torch_disc_like(disc, params[0], load=False)),
                            calibrated=True)
    assert drawn >= 8
    assert bad == []


def test_melgan_draws_like_the_jax_package():
    kw = {"n_mels": 20, "ngf": 8, "n_residual_layers": 2, "ratios": (4, 2)}
    module = JMelGAN(**kw)
    init = jax.jit(lambda key: module.init(key, jnp.zeros((1, 16, 20))))
    bad, drawn = mismatches(
        [as_numpy(melgan_state_dict(numpy_tree(init(jax.random.PRNGKey(seed))["params"])))
         for seed in range(SEEDS)],
        seeded(lambda: MelGANGenerator(**kw, device="cpu")), calibrated=True)
    assert drawn >= 10
    assert bad == []
