"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels, which run here in interpret mode:

- `ops.denoiser_stack.fused_residual_stack_plain` vs
  `mixgantts_tpu.ops.pallas.fused_residual_stack` (tolerance 2e-5, as
  test_pallas.py), over several tiles, a short tile and one short sequence;
- `ops.mrf.mrf_stack_plain` / `mrf_stack_folded` vs `mrf_stack` /
  `mrf_stack_folded` of `mixgantts_tpu.ops.pallas_vocoder` (rtol 1e-4,
  atol 1e-5, as test_pallas.py), with tile seams, one branch, the C = 128
  boundary and prefolded input;
- `ops.mrf.mrf_stack_streamed` vs `mrf_stack_streamed` of
  `mixgantts_tpu.ops.pallas_vocoder` at C = 256 (same tolerance), across
  tile seams, with T not a multiple of the tile, and at B = 2.

On CPU tensors the port's entry points take the plain versions, which
the entry-point cases check too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.models.blocks import Conv1d, StepEmbeddingMLP
from mixgantts_tpu.models.denoiser import Denoiser
from mixgantts_tpu.ops import pallas as jpallas
from mixgantts_tpu.ops import pallas_vocoder as jvoc
from mixgantts_tpu_torch.ops import denoiser_stack as tden
from mixgantts_tpu_torch.ops import mrf as tmrf
from test_pallas import _mrf_stage


def as_torch(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()
            if k != "fold"}


def denoiser_case(B, T, L, C, Hc, seed):
    r = np.random.RandomState(seed)
    x_t = r.randn(B, T, 20).astype(np.float32)
    t = np.arange(B, dtype=np.int32) % 4
    cond = r.randn(B, T, Hc).astype(np.float32)
    den = Denoiser(n_mels=20, d_encoder=Hc, residual_channels=C,
                   residual_layers=L, fused=False)
    params = jax.jit(den.init)(jax.random.PRNGKey(seed), x_t, t, cond)["params"]
    x = jax.nn.relu(jax.jit(Conv1d(C, 1).apply)(
        {"params": params["input_projection"]}, jnp.asarray(x_t)))
    step = jax.jit(StepEmbeddingMLP(C, C).apply)({"params": params["mlp"]}, jnp.asarray(t))
    return x, jnp.asarray(cond), step, jpallas.stack_denoiser_params(params)


@pytest.mark.parametrize("B,T,L,C,Hc,tile", [
    (1, 70, 3, 16, 24, 32),    # three tiles, the last one short
    (2, 9, 2, 8, 8, None),     # one short tile
    (2, 50, 4, 32, 48, None),  # one tile
])
def test_denoiser_stack_plain_matches_pallas(B, T, L, C, Hc, tile):
    x, cond, step, stacked = denoiser_case(B, T, L, C, Hc, seed=T)
    want_x, want_s = jpallas.fused_residual_stack(
        x, cond, step, stacked, tile=tile, interpret=True)
    args = (torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(cond)),
            torch.as_tensor(np.asarray(step)), as_torch(stacked))
    for fn in (tden.fused_residual_stack_plain, tden.fused_residual_stack):
        got_x, got_s = fn(*args)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=2e-5, atol=2e-5)


def mrf_case(C, T, B, rks, seed):
    x = jnp.asarray(np.random.RandomState(seed).randn(B, T, C), jnp.float32)
    params = _mrf_stage(C, rks).init(jax.random.PRNGKey(seed), x)["params"]
    return x, params


@pytest.mark.parametrize("C,T,B,rks,tile", [
    (16, 103, 2, (3, 7, 11), 56),   # tile seams and a ragged last tile
    (16, 40, 1, (11,), None),       # one branch, as the C = 256 stage runs
    (128, 40, 1, (3,), None),       # the C = 128 boundary
])
def test_mrf_stack_plain_matches_pallas(C, T, B, rks, tile):
    x, params = mrf_case(C, T, B, rks, seed=C + T)
    st = jvoc.stack_mrf_params(params, 0, rks)
    want = jvoc.mrf_stack(x, st, rks, tile=tile, interpret=True)
    xt = torch.as_tensor(np.asarray(x))
    for fn in (tmrf.mrf_stack_plain, tmrf.mrf_stack):
        got = fn(xt, as_torch(st), rks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fold,tile", [(2, None), (4, None), (4, 32)])
def test_mrf_stack_folded_plain_matches_pallas(fold, tile):
    C, T, B = 16, 96, 2
    x, params = mrf_case(C, T, B, (3, 7, 11), seed=fold)
    xf = x.reshape(B, T // fold, fold * C)   # contiguous == folded layout
    want = jvoc.mrf_stack_folded(
        xf, jvoc.stack_mrf_params_folded(params, 0, fold), tile=tile,
        interpret=True, prefolded=True)
    st = dict(as_torch(jvoc.stack_mrf_params(params, 0)), fold=fold)
    got = tmrf.mrf_stack_folded(torch.as_tensor(np.asarray(xf)), st, prefolded=True)
    assert got.shape == (B, T, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    got = tmrf.mrf_stack_folded(torch.as_tensor(np.asarray(x)), st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,T,tile", [
    (2, 100, 48),    # two seams, a ragged last tile, two batch rows
    (1, 40, None),   # one tile
])
def test_mrf_stack_streamed_matches_pallas(B, T, tile):
    C, rks = 256, (3, 7, 11)
    x, params = mrf_case(C, T, B, rks, seed=T)
    st = jvoc.stack_mrf_params(params, 0, rks)
    want = jvoc.mrf_stack_streamed(x, st, rks, tile=tile, interpret=True)
    got = tmrf.mrf_stack_streamed(torch.as_tensor(np.asarray(x)), as_torch(st), rks)
    assert tmrf.mrf_stack_streamed.launches == 0   # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_kernel_entry_points_reject_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    computed somewhere else."""
    x = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tmrf.mrf_stack(x, {}, (3,))
    with pytest.raises(ValueError, match="no kernel"):
        tmrf.mrf_stack_streamed(x, {}, (3,))
    with pytest.raises(ValueError, match="no kernel"):
        tden.fused_residual_stack(x, x, x[:, 0], {})
