"""The port's sequence ops (`mixgantts_tpu_torch.ops`) against the JAX
package's (`mixgantts_tpu.ops`) on ragged lengths.  Integer outputs must be
equal; float outputs agree to 1e-6 (fp32, the same arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu import ops as jops
from mixgantts_tpu.ops.schedules import get_noise_schedule_list as j_schedule
from mixgantts_tpu.utils.tools import bucket_length as j_bucket
from mixgantts_tpu_torch import ops as tops
from mixgantts_tpu_torch.ops.schedules import get_noise_schedule_list as t_schedule
from mixgantts_tpu_torch.utils.tools import bucket_length as t_bucket


def ragged(seed, B=3, W=5, P=16):
    """Phones per word with empty padding words, and frames per word with
    a zero-duration word."""
    r = np.random.RandomState(seed)
    w_len = r.randint(1, W + 1, B)
    wb = r.randint(1, 4, (B, W)) * (np.arange(W)[None] < w_len[:, None])
    dur = r.randint(0, 6, (B, W)) * (np.arange(W)[None] < w_len[:, None])
    x = r.randn(B, P, 8).astype(np.float32)
    return wb.astype(np.int64), dur.astype(np.int64), w_len, x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequence_mask_and_segment_ids(seed):
    wb, _, w_len, _ = ragged(seed)
    np.testing.assert_array_equal(
        tops.sequence_mask(torch.as_tensor(w_len), 7).numpy(),
        np.asarray(jops.sequence_mask(jnp.asarray(w_len), 7)))
    np.testing.assert_array_equal(
        tops.segment_ids_from_counts(torch.as_tensor(wb), 16).numpy(),
        np.asarray(jops.segment_ids_from_counts(jnp.asarray(wb), 16)))


@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("seed", [0, 1])
def test_word_level_pooling(seed, reduce):
    wb, _, _, x = ragged(seed)
    got = tops.word_level_pooling(torch.as_tensor(x), torch.as_tensor(wb), 5, reduce)
    want = jops.word_level_pooling(jnp.asarray(x), jnp.asarray(wb), 5, reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_length_regulate(seed):
    _, dur, _, x = ragged(seed)
    xw = x[:, :5]
    got, got_len = tops.length_regulate(torch.as_tensor(xw), torch.as_tensor(dur), 12)
    want, want_len = jops.length_regulate(jnp.asarray(xw), jnp.asarray(dur), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mapping_mask_and_rel_position_coef(seed):
    wb, dur, _, _ = ragged(seed)
    np.testing.assert_array_equal(
        tops.mapping_mask(torch.as_tensor(dur), torch.as_tensor(wb), 20, 16, 5).numpy(),
        np.asarray(jops.mapping_mask(jnp.asarray(dur), jnp.asarray(wb), 20, 16, 5)))
    mel_len = dur.sum(-1)
    mask = np.arange(20)[None] < mel_len[:, None]
    got = tops.rel_position_coef(torch.as_tensor(dur), 20, torch.as_tensor(mask))
    want = jops.rel_position_coef(jnp.asarray(dur), 20, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,steps", [("vpsde", 4), ("vpsde", 1),
                                        ("linear", 3), ("cosine", 5)])
def test_noise_schedules(mode, steps):
    np.testing.assert_array_equal(t_schedule(mode, steps, 0.1, 40, 0.008),
                                  j_schedule(mode, steps, 0.1, 40, 0.008))


def test_bucket_length():
    for n in (1, 64, 65, 1000, 1001):
        assert t_bucket(n, (64, 128, 1000)) == j_bucket(n, (64, 128, 1000))
