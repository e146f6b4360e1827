"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where no CUDA device is present (decided inside the
fixture).  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py

TF32 is off for cuDNN convolutions and matmuls, so the plain versions run
in full fp32.  Tolerance: max|kernel - plain| <= 1e-4 * max|plain| + 1e-5
(fp32 sums taken in another order; the denoiser's cross-block atomics add
run-to-run order changes).
"""

import numpy as np
import pytest
import torch

from mixgantts_tpu_torch.ops.denoiser_stack import (
    fused_residual_stack, fused_residual_stack_plain,
)
from mixgantts_tpu_torch.ops.mrf import (
    TAPS, mrf_stack, mrf_stack_folded, mrf_stack_plain, mrf_stack_streamed,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def assert_close(got, want):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    bound = 1e-4 * want.abs().max().item() + 1e-5
    assert torch.isfinite(got).all()
    assert err <= bound, f"max|diff|={err:.3g} > {bound:.3g}"


def denoiser_inputs(B, T, C=256, Hc=256, L=20, seed=0, device="cuda"):
    r = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(r.randn(*shape) * scale, dtype=torch.float32,
                            device=device)

    stacked = {
        "conv_w": t(L, 3, C, 2 * C, scale=(3 * C) ** -0.5),
        "conv_b": t(L, 2 * C, scale=0.1),
        "cond_w": t(L, Hc, C, scale=Hc ** -0.5),
        "cond_b": t(L, C, scale=0.1),
        "step_w": t(L, C, C, scale=C ** -0.5),
        "out_w": t(L, C, 2 * C, scale=C ** -0.5),
        "out_b": t(L, 2 * C, scale=0.1),
    }
    return t(B, T, C), t(B, T, Hc), t(B, C), stacked


@pytest.mark.parametrize("B,T", [(1, 256), (1, 1000), (4, 1000), (2, 37)])
def test_denoiser_stack_kernel_matches_plain(cuda, B, T):
    x, cond, step, stacked = denoiser_inputs(B, T)
    n0 = fused_residual_stack.launches
    got_x, got_s = fused_residual_stack(x, cond, step, stacked)
    torch.cuda.synchronize()
    assert fused_residual_stack.launches == n0 + 20
    want_x, want_s = fused_residual_stack_plain(x, cond, step, stacked)
    assert_close(got_x, want_x)
    assert_close(got_s, want_s)


def mrf_weights(C, kernel_sizes, n_pair=3, seed=0, device="cuda"):
    r = np.random.RandomState(seed)
    n_br = len(kernel_sizes)
    w1 = np.zeros((n_br, n_pair, TAPS, C, C), np.float32)
    w2 = np.zeros_like(w1)
    for br, k in enumerate(kernel_sizes):
        pad = (TAPS - k) // 2
        w1[br, :, pad:pad + k] = r.randn(n_pair, k, C, C) * (k * C) ** -0.5
        w2[br, :, pad:pad + k] = r.randn(n_pair, k, C, C) * (k * C) ** -0.5
    b = r.randn(2, n_br, n_pair, C).astype(np.float32) * 0.1
    as_t = lambda a: torch.tensor(a, device=device)
    return {"w1": as_t(w1), "w2": as_t(w2), "b1": as_t(b[0]), "b2": as_t(b[1])}


@pytest.mark.parametrize("C,T,kernel_sizes", [
    (256, 8000, (3,)), (256, 8000, (7,)), (256, 8000, (11,)),
    (128, 64000, (3, 7, 11)), (128, 300, (3, 7, 11)), (256, 70, (11,)),
])
def test_mrf_stack_kernel_matches_plain(cuda, C, T, kernel_sizes):
    x = torch.randn(1, T, C, device=cuda, generator=torch.Generator(
        cuda).manual_seed(C + T))
    st = mrf_weights(C, kernel_sizes)
    n0 = mrf_stack.launches
    got = mrf_stack(x, st, kernel_sizes)
    torch.cuda.synchronize()
    assert mrf_stack.launches == n0 + 3 * len(kernel_sizes)
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes))


@pytest.mark.parametrize("C,T", [(64, 128000), (32, 256000), (32, 1000),
                                 (64, 130)])
def test_mrf_stack_folded_kernel_matches_plain(cuda, C, T):
    fold = 128 // C
    x = torch.randn(2, T, C, device=cuda, generator=torch.Generator(
        cuda).manual_seed(T))
    st = dict(mrf_weights(C, (3, 7, 11)), fold=fold)
    n0 = mrf_stack_folded.launches
    got = mrf_stack_folded(x.reshape(2, T // fold, fold * C), st,
                           prefolded=True)
    torch.cuda.synchronize()
    assert mrf_stack_folded.launches == n0 + 9
    assert got.shape == x.shape
    assert_close(got, mrf_stack_plain(x, st))


@pytest.mark.parametrize("B,T,kernel_sizes", [
    (2, 1000, (3, 7, 11)),   # ragged last tile, two batch rows
    (1, 37, (3, 7, 11)),     # shorter than one pass
    (1, 300, (11,)),         # one branch
    (1, 8000, (3, 7, 11)),   # the main path's shapes: 64-frame tiles
    (4, 4096, (3, 7, 11)),   # and 128-frame tiles
])
def test_mrf_stack_streamed_kernel_matches_plain(cuda, B, T, kernel_sizes):
    x = torch.randn(B, T, 256, device=cuda, generator=torch.Generator(
        cuda).manual_seed(B * T))
    st = mrf_weights(256, kernel_sizes)
    n0 = mrf_stack_streamed.launches
    got = mrf_stack_streamed(x, st, kernel_sizes)
    torch.cuda.synchronize()
    assert mrf_stack_streamed.launches == n0 + 1
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes))


def test_kernels_reject_what_they_do_not_take(cuda):
    """Non-contiguous or non-fp32 input raises; nothing is copied or
    computed another way."""
    x, cond, step, stacked = denoiser_inputs(1, 64, L=2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_residual_stack(torch.cat([x, x], 1)[:, ::2], cond, step, stacked)
    with pytest.raises(ValueError, match="float32"):
        fused_residual_stack(x.double(), cond, step, stacked)
    st = mrf_weights(32, (3,))
    y = torch.randn(1, 32, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_stack(y.transpose(1, 2), st, (3,))
    with pytest.raises(ValueError, match="built for"):
        mrf_stack(torch.randn(1, 64, 48, device=cuda), mrf_weights(48, (3,)), (3,))
    with pytest.raises(ValueError, match="built for 256"):
        mrf_stack_streamed(torch.randn(1, 64, 128, device=cuda),
                           mrf_weights(128, (3,)), (3,))
