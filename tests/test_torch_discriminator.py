"""The port's JCU discriminator against the JAX package's on the CPU, with
the same weights (`convert.discriminator_state_dict`, strict load): every
feature list of both branches, single and multi-speaker, at rtol 1e-5
(atol 1e-6), and the bridge against the reference layout that
`mixgantts_tpu/export.py` writes."""

import jax
import numpy as np
import pytest
import torch

from mixgantts_tpu.export import export_discriminator
from torch_port_helpers import assert_close, numpy_tree, t
from torch_train_helpers import N_MELS, tiny_disc, torch_disc_like

H = 32   # the speaker embedding's width (the generator's hidden)


def setup(multi_speaker, seed=0, B=3, T=13):
    disc = tiny_disc(multi_speaker)
    r = np.random.RandomState(seed)
    x_t, x_prev = (r.randn(B, T, N_MELS).astype(np.float32) for _ in range(2))
    spk = r.randn(B, H).astype(np.float32) if multi_speaker else None
    steps = np.array([0, 3, 1])[:B]
    params = numpy_tree(disc.init(jax.random.PRNGKey(seed), x_t, x_prev, spk, steps)["params"])
    # random biases, so the bias terms are tested too (they start at zero)
    for name, p in params.items():
        if "conv" in name:
            p["conv"]["bias"] = r.randn(*p["conv"]["bias"].shape).astype(np.float32) * 0.1
    return disc, params, (x_t, x_prev, spk, steps)


@pytest.mark.parametrize("multi_speaker", [False, True])
def test_discriminator_matches_flax(multi_speaker):
    """The odd frame count exercises the strided convolutions' padding."""
    disc, params, (x_t, x_prev, spk, steps) = setup(multi_speaker)
    want_c, want_u = disc.apply({"params": params}, x_t, x_prev, spk, steps)
    port = torch_disc_like(disc, params)
    with torch.no_grad():
        got_c, got_u = port(t(x_t), t(x_prev), None if spk is None else t(spk), t(steps))
    assert len(got_c) == len(want_c) == 5 and len(got_u) == len(want_u) == 5
    for got, want in zip(got_c + got_u, want_c + want_u):
        assert got.shape == want.shape
        assert_close(got, want, rtol=1e-5, atol=1e-6)
    if multi_speaker:
        # the speaker term reaches the conditional branch only
        with torch.no_grad():
            c0, u0 = port(t(x_t), t(x_prev), None, t(steps))
        assert not torch.allclose(c0[-1], got_c[-1])
        assert torch.equal(u0[-1], got_u[-1])


@pytest.mark.parametrize("multi_speaker", [False, True])
def test_discriminator_bridge_is_the_reference_layout(multi_speaker):
    """The bridge's keys and values are those of the reference's "D" that
    `export_discriminator` writes, which loads into the port strictly."""
    disc, params, _ = setup(multi_speaker)
    port = torch_disc_like(disc, params)
    exported = export_discriminator(params)
    assert set(exported) == set(port.state_dict())
    port.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in exported.items()},
                         strict=True)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(exported[k]), err_msg=k)
