"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where no CUDA device is present (decided inside the
fixture).  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py

TF32 is off for cuDNN convolutions and matmuls, so the plain versions run
in full fp32.  The MRF kernels (behind `mrf_stack` / `mrf_stack_folded`,
and the whole-stage `mrf_stack_streamed`) and the denoiser kernel compute
with bf16 operands and fp32 accumulation, as the TPU kernels do; each is
held against its plain version with the same bf16 weights (which
rounds where it rounds) at 4e-3 * max|plain| + 1e-5, one bf16 step of the
largest value: the same products summed in another order, plus bf16
rounding flips of an intermediate (the MRF's conv1 output, the denoiser's y
and g) where the two sums straddle a rounding boundary.  The denoiser
kernel with a multi-speaker model's speaker term (in its conditioner
projection) is held to the same bar, and so is every width C <= 256 (the
kernel runs at the next of 64, 128 and 256 with zero channels above C).  Fed bf16 activations (a model
computing in bf16), the kernels upcast them exactly and must give the same
bits as when fed that fp32 upcast, rounded to bf16.
"""

import numpy as np
import pytest
import torch

from mixgantts_tpu_torch.models.denoiser import Denoiser
from mixgantts_tpu_torch.ops import denoiser_stack
from mixgantts_tpu_torch.ops.denoiser_stack import (
    denoiser_kernel_weights, fused_residual_stack, fused_residual_stack_plain,
    speaker_projections,
)
from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator
from mixgantts_tpu_torch.ops.mrf import (
    TAPS, kernel_weights, mrf_stack, mrf_stack_folded, mrf_stack_plain, mrf_stack_streamed,
    streamed_plan, tile_frames,
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


BF16_TOL = 4e-3   # the bf16 kernels against their bf16 plain versions


def assert_close(got, want, rel=1e-4):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    bound = rel * want.abs().max().item() + 1e-5
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


@pytest.mark.parametrize("B,T,C", [
    (1, 256, 256), (1, 1000, 256), (4, 1000, 256),
    (2, 37, 256),     # shorter than one 64-frame tile
    (1, 333, 256),    # a ragged last tile
    (3, 200, 128),    # C = 128: clusters of 4
    (1, 2500, 256),   # more tiles than the card holds clusters: one launch per layer
])
def test_denoiser_stack_kernel_matches_plain(cuda, B, T, C):
    x, cond, step, stacked = denoiser_inputs(B, T, C=C)
    stacked = denoiser_kernel_weights(stacked)
    n0 = fused_residual_stack.launches
    got_x, got_s = fused_residual_stack(x, cond, step, stacked)
    torch.cuda.synchronize()
    ctas, _, resident = denoiser_stack.launch_shape(B, T, C)
    tiles = -(-T // 64)
    fit = resident // tiles   # batch rows per launch of all the layers
    assert fused_residual_stack.launches - n0 == (-(-B // fit) if fit else 20)
    want_x, want_s = fused_residual_stack_plain(x, cond, step, stacked)
    assert_close(got_x, want_x, BF16_TOL)
    assert_close(got_s, want_s, BF16_TOL)


@pytest.mark.parametrize("B,T", [
    (2, 300),    # all layers in one launch
    (1, 2500),   # one launch per layer
])
def test_denoiser_fp32_weights_are_cast_and_runs_repeat(cuda, B, T):
    """fp32 stacked weights run the same bf16 kernel (cast per call, as the
    JAX package casts them on the TPU); each CTA owns its outputs, with no
    atomics, so every run gives the same bits, in either launch scheme."""
    x, cond, step, stacked = denoiser_inputs(B, T)
    kw = denoiser_kernel_weights(stacked)
    got = fused_residual_stack(x, cond, step, stacked)
    for _ in range(2):
        again = fused_residual_stack(x, cond, step, kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, fused_residual_stack_plain(x, cond, step, kw)):
        assert_close(a, b, BF16_TOL)


@pytest.mark.parametrize("B,T", [(1, 1000), (4, 512), (2, 37)])
def test_denoiser_kernel_with_speaker_term_matches_plain(cuda, B, T):
    """The speaker term [L, B, C] rides in the conditioner projection (a
    `baddbmm` bias): the same kernel, the same launches, against the plain
    bf16 version given the same term."""
    x, cond, step, stacked = denoiser_inputs(B, T)
    r = np.random.RandomState(B)
    stacked["spk_w"] = torch.tensor(r.randn(20, 256, 256) * 256 ** -0.5, dtype=torch.float32,
                                    device=cuda)
    kw = denoiser_kernel_weights(stacked)
    spk = speaker_projections(torch.randn(B, 256, device=cuda), kw)
    n0 = fused_residual_stack.launches
    got = fused_residual_stack(x, cond, step, kw, spk)
    torch.cuda.synchronize()
    n = fused_residual_stack.launches - n0
    fused_residual_stack(x, cond, step, kw)
    assert n == fused_residual_stack.launches - n0 - n > 0
    want = fused_residual_stack_plain(x, cond, step, kw, spk)
    for a, b in zip(got, want):
        assert_close(a, b, BF16_TOL)
    without = fused_residual_stack_plain(x, cond, step, kw)
    assert (got[1] - without[1]).abs().max() > 1e-2


@pytest.mark.parametrize("speaker", [False, True], ids=["one_speaker", "multi_speaker"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("C", [16, 32, 48, 64, 80, 192, 256])
def test_denoiser_kernel_at_every_width(cuda, C, B, speaker):
    """Every C <= 256 runs the kernel, at the next of 64, 128 and 256 with
    zero channels above C (`kernel_width`), and matches its plain version
    at C; the launch count rises."""
    x, cond, step, stacked = denoiser_inputs(B, 300, C=C, Hc=64, seed=C + B)
    spk = None
    if speaker:
        r = np.random.RandomState(C)
        stacked["spk_w"] = torch.tensor(r.randn(20, 64, C) * 64 ** -0.5, dtype=torch.float32,
                                        device=cuda)
    kw = denoiser_kernel_weights(stacked)
    if speaker:
        spk = speaker_projections(torch.randn(B, 64, device=cuda), kw)
    n0 = fused_residual_stack.launches
    got = fused_residual_stack(x, cond, step, kw, spk)
    torch.cuda.synchronize()
    assert fused_residual_stack.launches > n0
    for a, b in zip(got, fused_residual_stack_plain(x, cond, step, kw, spk)):
        assert a.shape == (B, 300, C)
        assert_close(a, b, BF16_TOL)


def test_denoiser_of_width_16_runs_the_kernel(cuda):
    """A `Denoiser` with residual_channels 16 (the tiny configs') runs
    inference through the kernel, and matches the same module's bf16 plain
    stack on the CPU."""
    torch.manual_seed(0)
    den = Denoiser(n_mels=20, d_encoder=32, residual_channels=16, residual_layers=2).to(cuda)
    with torch.no_grad():
        den.output_projection.conv.weight.normal_(0, 0.1)
    r = np.random.RandomState(16)
    x_t = torch.tensor(r.randn(2, 150, 20), dtype=torch.float32)
    t = torch.tensor([0, 1])
    cond = torch.tensor(r.randn(2, 150, 32), dtype=torch.float32)
    n0 = fused_residual_stack.launches
    with torch.no_grad():
        got = den(x_t.to(cuda), t.to(cuda), cond.to(cuda))
        torch.cuda.synchronize()
        assert fused_residual_stack.launches > n0
        cpu = Denoiser(n_mels=20, d_encoder=32, residual_channels=16, residual_layers=2)
        cpu.load_state_dict({k: v.cpu() for k, v in den.state_dict().items()})
        cpu.stack_dtype = torch.bfloat16
        want = cpu(x_t, t, cond)
    assert_close(got.cpu(), want, BF16_TOL)


def test_kernels_take_bf16_activations_bit_equal(cuda):
    """bf16 x (and cond, step embedding, speaker term's embedding) give
    exactly the fp32 upcast's result, rounded to bf16; the denoiser's hoisted
    projections are rounded to bf16 on that path (`_launch` with dtype
    bf16 on the upcast inputs)."""
    x, cond, step, stacked = denoiser_inputs(2, 300)
    kw = denoiser_kernel_weights(stacked)
    xb, cb, sb = x.bfloat16(), cond.bfloat16(), step.bfloat16()
    got = fused_residual_stack(xb, cb, sb, kw)
    want = denoiser_stack._launch(xb.float(), cb.float(), sb.float(), kw, None, torch.bfloat16)
    for a, b in zip(got, want[:2]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.bfloat16())
    for C, kernel_sizes in ((256, (11,)), (128, (3, 7, 11))):
        y = torch.randn(2, 700, C, device=cuda).bfloat16()
        st = kernel_weights(mrf_weights(C, kernel_sizes), kernel_sizes)
        got = mrf_stack(y, st, kernel_sizes)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, mrf_stack(y.float(), st, kernel_sizes).bfloat16())
    y = torch.randn(2, 1000, 32, device=cuda).bfloat16()
    st = dict(kernel_weights(mrf_weights(32, (3, 7, 11))), fold=4)
    got = mrf_stack_folded(y.reshape(2, 250, 128), st, prefolded=True)
    assert torch.equal(got, mrf_stack_folded(y.float().reshape(2, 250, 128), st,
                                             prefolded=True).bfloat16())
    y = torch.randn(1, 800, 256, device=cuda).bfloat16()
    st = kernel_weights(mrf_weights(256, (3, 7, 11)))
    assert torch.equal(mrf_stack_streamed(y, st), mrf_stack_streamed(y.float(), st).bfloat16())


def test_denoiser_stacks_bf16_on_cuda(cuda):
    """On CUDA the denoiser stacks its weights once, in bf16 with the
    kernel's layout; `stack_dtype` = fp32 keeps fp32 weights (cast per
    call)."""
    torch.manual_seed(0)
    den = Denoiser(n_mels=20, d_encoder=32, residual_channels=128, residual_layers=2).to(cuda)
    st = den.stacked()
    assert st["conv_w"].dtype == torch.bfloat16 and "conv_w_mma" in st
    assert den.stacked() is st
    den.stack_dtype = torch.float32
    assert den.stacked()["conv_w"].dtype == torch.float32


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
    st = kernel_weights(mrf_weights(C, kernel_sizes), kernel_sizes)
    n0 = mrf_stack.launches
    got = mrf_stack(x, st, kernel_sizes)
    torch.cuda.synchronize()
    assert mrf_stack.launches == n0 + 3 * len(kernel_sizes)
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes), BF16_TOL)


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("case", ["shorter than one tile", "ragged last tile at k=11"])
def test_mrf_stack_kernel_tile_edges(cuda, C, case):
    """T shorter than one block's frames, and a k = 11 branch (dilations up
    to 5) whose last block is ragged, at every width."""
    frames = tile_frames(C, 11)
    T = frames // 2 if case.startswith("shorter") else 3 * frames + 5
    kernel_sizes = (3, 7, 11) if case.startswith("shorter") else (11,)
    x = torch.randn(2, T, C, device=cuda, generator=torch.Generator(cuda).manual_seed(T))
    st = kernel_weights(mrf_weights(C, kernel_sizes), kernel_sizes)
    got = mrf_stack(x, st, kernel_sizes)
    torch.cuda.synchronize()
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes), BF16_TOL)


def test_fp32_weights_are_cast_to_bf16(cuda):
    """fp32 stacked weights run the same bf16 kernel (cast per call, as the
    JAX package casts them on the TPU)."""
    x = torch.randn(1, 500, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    st = mrf_weights(64, (3, 7, 11))
    got = mrf_stack(x, st)
    assert torch.equal(got, mrf_stack(x, kernel_weights(st)))
    assert_close(got, mrf_stack_plain(x, kernel_weights(st)), BF16_TOL)


@pytest.mark.parametrize("C,T", [(64, 128000), (32, 256000), (32, 1000),
                                 (64, 130)])
def test_mrf_stack_folded_kernel_matches_plain(cuda, C, T):
    fold = 128 // C
    x = torch.randn(2, T, C, device=cuda, generator=torch.Generator(
        cuda).manual_seed(T))
    st = dict(kernel_weights(mrf_weights(C, (3, 7, 11))), fold=fold)
    n0 = mrf_stack_folded.launches
    got = mrf_stack_folded(x.reshape(2, T // fold, fold * C), st,
                           prefolded=True)
    torch.cuda.synchronize()
    assert mrf_stack_folded.launches == n0 + 9
    assert got.shape == x.shape
    assert_close(got, mrf_stack_plain(x, st), BF16_TOL)


@pytest.mark.parametrize("B,T,kernel_sizes", [
    (2, 1000, (3, 7, 11)),   # ragged last tile, two batch rows
    (1, 37, (3, 7, 11)),     # shorter than one pass
    (1, 300, (11,)),         # one branch
    (1, 8000, (3, 7, 11)),   # the main path's shapes: 30 clusters of 267 frames
    (4, 4096, (3, 7, 11)),   # and 28 of 586
])
def test_mrf_stack_streamed_kernel_matches_plain(cuda, B, T, kernel_sizes):
    x = torch.randn(B, T, 256, device=cuda, generator=torch.Generator(
        cuda).manual_seed(B * T))
    st = kernel_weights(mrf_weights(256, kernel_sizes), kernel_sizes)
    n0 = mrf_stack_streamed.launches
    got = mrf_stack_streamed(x, st, kernel_sizes)
    torch.cuda.synchronize()
    assert mrf_stack_streamed.launches == n0 + 1
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes), BF16_TOL)


@pytest.mark.parametrize("B,T", [(1, 8000), (4, 4096)])
def test_mrf_stack_streamed_fp32_weights_are_cast_and_runs_repeat(cuda, B, T):
    """fp32 stacked weights run the same bf16 kernel (cast per call); each
    CTA owns its rows and channels of the output and of the y slab, with no
    atomics, so every run gives the same bits."""
    x = torch.randn(B, T, 256, device=cuda, generator=torch.Generator(cuda).manual_seed(T))
    st = mrf_weights(256, (3, 7, 11))
    got = mrf_stack_streamed(x, st)
    kw = kernel_weights(st)
    for _ in range(2):
        assert torch.equal(got, mrf_stack_streamed(x, kw))
    plan = streamed_plan(B, T)   # every cluster resident at once
    assert B * -(-T // plan["tile"]) <= plan["resident"]


def test_kernels_reject_what_they_do_not_take(cuda):
    """Non-contiguous or non-fp32 input raises; nothing is copied or
    computed another way."""
    x, cond, step, stacked = denoiser_inputs(1, 64, L=2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_residual_stack(torch.cat([x, x], 1)[:, ::2], cond, step, stacked)
    with pytest.raises(ValueError, match="float32"):
        fused_residual_stack(x.double(), cond, step, stacked)
    with pytest.raises(ValueError, match="bfloat16"):   # the denoiser takes bf16 (or casts fp32)
        fused_residual_stack(x, cond, step, dict(stacked, conv_w=stacked["conv_w"].half()))
    with pytest.raises(ValueError, match="on cuda"):
        fused_residual_stack(x, cond.cpu(), step, stacked)
    with pytest.raises(ValueError, match="C <= 256"):   # every narrower width runs
        fused_residual_stack(*denoiser_inputs(1, 64, C=320, Hc=64, L=2))
    kw = denoiser_kernel_weights(stacked)
    with pytest.raises(ValueError, match="denoiser_kernel_weights"):
        fused_residual_stack(x, cond, step, dict(kw, out_w_mma=kw["out_w_mma"].float()))
    st = mrf_weights(32, (3,))
    y = torch.randn(1, 32, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_stack(y.transpose(1, 2), st, (3,))
    with pytest.raises(ValueError, match="built for"):
        mrf_stack(torch.randn(1, 64, 48, device=cuda), mrf_weights(48, (3,)), (3,))
    with pytest.raises(ValueError, match="built for 256"):
        mrf_stack_streamed(torch.randn(1, 64, 128, device=cuda),
                           mrf_weights(128, (3,)), (3,))
    y = torch.randn(1, 64, 32, device=cuda)
    wide = mrf_weights(256, (3,))
    y256 = torch.randn(1, 64, 256, device=cuda)
    for dtype in (torch.float16, torch.float64):   # the MRF kernels take bf16 (or cast fp32)
        with pytest.raises(ValueError, match="bfloat16"):
            mrf_stack(y, dict(st, w1=st["w1"].to(dtype), w2=st["w2"].to(dtype)), (3,))
        with pytest.raises(ValueError, match="bfloat16"):
            mrf_stack_streamed(y256, dict(wide, w1=wide["w1"].to(dtype),
                                          w2=wide["w2"].to(dtype)), (3,))
    for w in (wide, kernel_weights(wide, (3,))):
        mrf_stack_streamed(y256, w, (3,))
    with pytest.raises(ValueError, match="laid out for kernel sizes"):
        mrf_stack_streamed(y256, kernel_weights(mrf_weights(256, (7,)), (7,)), (3,))
    with pytest.raises(ValueError, match="laid out for kernel sizes"):
        mrf_stack(y, kernel_weights(st, (3,)), (7,))


def test_fused_apply_stacks_bf16_on_cuda(cuda):
    """On CUDA the vocoder stacks each stage's MRF weights once, in bf16 and
    the kernel's layout, and serving converts nothing per call."""
    torch.manual_seed(0)
    gen = HiFiGANGenerator(n_mels=20, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                           upsample_initial_channel=128, device=cuda)
    mel = torch.randn(1, 40, 20, device=cuda)
    with torch.no_grad():
        gen(mel)
    assert gen._stacked and all(
        key[2] == torch.bfloat16 and st["w1"].dtype == torch.bfloat16 and "w1_mma" in st
        for key, st in gen._stacked.items())
