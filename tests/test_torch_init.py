"""The flax-default re-initialisation of `tests/horizon_init_witness_torch.py`
draws from the JAX HiFi-GAN's distributions.

The witness vocodes a drive's mel with the random HiFi-GAN as the port
builds it (torch's default initialisers) and re-initialised as the JAX
package initialises it (`jax_init`); its reading says something about
the JAX package's init only if that re-initialisation draws from the same
distributions.  SEEDS inits of a small JAX HiFi-GAN, bridged to the port's
names and layouts (`convert.hifigan_state_dict`), against SEEDS of the
port's generator through `jax_init`, pooled per parameter:

- what the JAX init sets to constants (zero biases) `jax_init` sets to
  the same constants;
- every other parameter has, pooled over the seeds, its std within 12% of
  JAX's (25% under 1024 values), its mean within 0.1 std of JAX's, and its
  max|x| / std within 25% of JAX's, which tells a uniform (sqrt 3), a
  normal truncated at two std (2 / 0.88) and a normal (above 3) apart;

and the port's own init (torch's defaults) fails the same comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizon_init_witness_torch import jax_init
from mixgantts_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from mixgantts_tpu_torch.convert import hifigan_state_dict
from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator
from test_vocoder import SMALL_CONFIG
from torch_port_helpers import numpy_tree

SEEDS = 16


def as_numpy(state):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float64)
            for k, v in state.items()}


def mismatches(jax_states, port_states):
    """The parameters whose pooled draws differ from JAX's (see the module
    docstring), and the number compared as drawn."""
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
            tail_j, tail_p = np.abs(j).max() / sj, np.abs(p).max() / sp
            ok = ok and abs(p.mean() - j.mean()) < 0.1 * sj and 0.8 < tail_p / tail_j < 1.25
        if not ok:
            bad.append(name)
    return bad, drawn


@pytest.mark.parametrize("init", ["jax_init", "torch_default"])
def test_witness_reinitialises_hifigan_like_the_jax_package(init):
    module = JHiFiGAN.from_config(SMALL_CONFIG)
    jinit = jax.jit(lambda key: module.init(key, jnp.zeros((1, 16, SMALL_CONFIG["num_mels"]))))
    jax_states = [as_numpy(hifigan_state_dict(numpy_tree(jinit(jax.random.PRNGKey(seed))
                                                         ["params"])))
                  for seed in range(SEEDS)]
    port_states = []
    for seed in range(SEEDS):
        torch.manual_seed(seed)
        gen = HiFiGANGenerator.from_config(SMALL_CONFIG, device="cpu")
        port_states.append(as_numpy((jax_init(gen, seed) if init == "jax_init" else gen)
                                    .state_dict()))
    bad, drawn = mismatches(jax_states, port_states)
    assert drawn >= 10
    if init == "jax_init":
        assert bad == []
    else:   # torch's defaults: every weight too narrow and uniform, every bias drawn
        assert len(bad) == len(jax_states[0])
