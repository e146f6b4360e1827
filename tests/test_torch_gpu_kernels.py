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
projection) is held to the same bar, and so is every width C <= 512 (the
kernel runs at the next of 64, 128, 256 and 512 with zero channels above
C) and above (the wide route, two launches a layer, at the next multiple of
64; the plain version never runs on CUDA), and every MRF width C <= 512 (at
the next of 8, 16, 32, 64, 128, 256 and 512; up to 16 the whole stage in
one launch of `csrc/mrf_stage_narrow.cu`, at 512 two launches a pair):
HiFi-GAN V2's stages, HiFi-GAN V1 at `upsample_initial_channel` 1024, and
the dryrun's synthesis at the JAX dryrun's widths, launch the kernels.  The MRF kernels take the TPU kernels'
shapes: every odd kernel size up to 11, any number of branches and pairs,
and every dilation schedule within the 64-frame halo (the whole-stage
kernel at 128 < C <= 512, run at 256 or 512, up to the widest conv1 reach,
63 frames).  Fed bf16 activations (a model
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
from mixgantts_tpu_torch.ops import mrf as mrf_ops
from mixgantts_tpu_torch.ops.mrf import (
    HALO, MAX_SMEM, TAPS, kernel_weights, mrf_stack, mrf_stack_folded, mrf_stack_plain,
    mrf_stack_streamed, narrow_plan, narrow_smem_bytes, stage_launches, streamed_plan,
    tile_frames,
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
# HiFi-GAN V2, the public config_v2.json of jik876/hifi-gan
V2_CONFIG = {"resblock": "1", "num_mels": 80, "upsample_rates": [8, 8, 2, 2],
             "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 128,
             "resblock_kernel_sizes": [3, 7, 11],
             "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]]}


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
@pytest.mark.parametrize("C", [16, 32, 48, 64, 80, 192, 256, 288, 384, 512,
                               544, 768, 1024, 2048])
def test_denoiser_kernel_at_every_width(cuda, C, B, speaker):
    """Every C <= 512 runs the kernel, at the next of 64, 128, 256 and 512
    with zero channels above C (`kernel_width`), every wider C the wide
    route (4 layers at T = 150 here: 8 launches), and matches its plain
    version at C; the launch count rises, and a second run gives the same
    bits."""
    wide = denoiser_stack.is_wide(C)
    L, T = (4, 150) if wide else (20, 300)
    x, cond, step, stacked = denoiser_inputs(B, T, C=C, Hc=64, L=L, seed=C + B)
    spk = None
    if speaker:
        r = np.random.RandomState(C)
        stacked["spk_w"] = torch.tensor(r.randn(L, 64, C) * 64 ** -0.5, dtype=torch.float32,
                                        device=cuda)
    kw = denoiser_kernel_weights(stacked)
    if speaker:
        spk = speaker_projections(torch.randn(B, 64, device=cuda), kw)
    n0 = fused_residual_stack.launches
    got = fused_residual_stack(x, cond, step, kw, spk)
    torch.cuda.synchronize()
    launched = fused_residual_stack.launches - n0
    assert launched == 2 * L if wide else launched > 0
    again = fused_residual_stack(x, cond, step, kw, spk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, fused_residual_stack_plain(x, cond, step, kw, spk)):
        assert a.shape == (B, T, C)
        assert_close(a, b, BF16_TOL)


def test_wide_denoiser_never_runs_the_plain_version(cuda, monkeypatch):
    """A `Denoiser` with residual_channels 768 runs inference on the wide
    route: with the plain layers and the block path made to raise, the
    kernel's launch count rises by two a layer, and the output matches the
    same module's bf16 plain stack on the CPU."""
    torch.manual_seed(0)
    den = Denoiser(n_mels=20, d_encoder=32, residual_channels=768, residual_layers=3).to(cuda)
    with torch.no_grad():
        den.output_projection.conv.weight.normal_(0, 0.1)
    r = np.random.RandomState(768)
    x_t = torch.tensor(r.randn(1, 200, 20), dtype=torch.float32)
    t = torch.tensor([2])
    cond = torch.tensor(r.randn(1, 200, 32), dtype=torch.float32)
    cpu = Denoiser(n_mels=20, d_encoder=32, residual_channels=768, residual_layers=3)
    cpu.load_state_dict({k: v.cpu() for k, v in den.state_dict().items()})
    cpu.stack_dtype = torch.bfloat16
    with torch.no_grad():
        want = cpu(x_t, t, cond)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA")

    for name in ("fused_residual_stack_plain", "residual_layers_plain", "_layers",
                 "_layers_bf16"):
        monkeypatch.setattr(denoiser_stack, name, refuse)
    monkeypatch.setattr(type(den.residual_layers[0]), "forward", refuse)
    n0 = fused_residual_stack.launches
    with torch.no_grad():
        got = den(x_t.to(cuda), t.to(cuda), cond.to(cuda))
        torch.cuda.synchronize()
    assert fused_residual_stack.launches - n0 == 6
    assert_close(got.cpu(), want, BF16_TOL)


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


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("C", [4, 8, 16, 24, 48, 72, 96, 144, 200])
def test_mrf_kernel_at_every_width(cuda, C, B):
    """Every C <= 256 runs the kernel, at the next of 8, 16, 32, 64, 128
    and 256 with zero channels above C (`kernel_width`), and matches its
    plain version at C: the whole three-branch stage up to 128, one branch a
    call above (as `fused_apply` calls it); the launch count rises at each
    call, by one for the whole stage at C <= 16."""
    x = torch.randn(B, 1000, C, device=cuda, generator=torch.Generator(cuda).manual_seed(C))
    calls = [(3, 7, 11)] if C <= 128 else [(3,), (7,), (11,)]
    for ks in calls:
        st = kernel_weights(mrf_weights(C, ks), ks)
        n0 = mrf_stack.launches
        got = mrf_stack(x, st, ks)
        torch.cuda.synchronize()
        assert mrf_stack.launches == n0 + stage_launches(C, len(ks), 3)
        assert got.shape == x.shape
        assert_close(got, mrf_stack_plain(x, st, ks), BF16_TOL)


@pytest.mark.parametrize("C", [4, 8, 16])
def test_mrf_stack_folded_kernel_at_narrow_widths(cuda, C):
    """The folded entry point at V2's and the dryrun's narrow stages (F =
    128 / C), the whole stage in one launch at 8 (C = 4, zero channels
    above) and at the stage's own width."""
    fold, T = 128 // C, 4096
    x = torch.randn(2, T, C, device=cuda, generator=torch.Generator(cuda).manual_seed(T + C))
    st = dict(kernel_weights(mrf_weights(C, (3, 7, 11))), fold=fold)
    n0 = mrf_stack_folded.launches
    got = mrf_stack_folded(x.reshape(2, T // fold, fold * C), st, prefolded=True)
    torch.cuda.synchronize()
    assert mrf_stack_folded.launches == n0 + 1
    assert got.shape == x.shape
    assert_close(got, mrf_stack_plain(x, st), BF16_TOL)


def test_hifigan_v2_runs_the_folded_kernel(cuda):
    """HiFi-GAN V2 (jik876/hifi-gan config_v2.json: stages 64, 32, 16, 8)
    from a seed: a B=1 mel at frame bucket 1000 takes the folded entry point
    at every stage: the pair kernel at 64 and 32 (9 launches each), the
    whole-stage kernel at 16 and 8 (one each; 20 in all, `mrf_stack` none),
    and its wave stays within
    the JAX package's bf16 vocoder bar (SNR > 30 dB) of the same generator's
    fp32 plain path on the CPU."""
    torch.manual_seed(2)
    gen = HiFiGANGenerator.from_config(V2_CONFIG, device="cpu")
    mel = torch.randn(1, 1000, 80, generator=torch.Generator().manual_seed(2)) - 5.0
    with torch.no_grad():
        want = gen(mel)
        gen.to(cuda)
        counts = mrf_stack.launches, mrf_stack_folded.launches
        got = gen(mel.to(cuda))
        torch.cuda.synchronize()
    assert (mrf_stack.launches - counts[0], mrf_stack_folded.launches - counts[1]) == (0, 20)
    got = got.cpu().double()
    snr = 10 * np.log10((want.double() ** 2).mean().item()
                        / ((got - want.double()) ** 2).mean().item())
    assert snr > 30, f"SNR {snr:.1f} dB"


def test_dryrun_widths_run_the_kernels(cuda):
    """The dryrun's synthesis model (denoiser 8 channels) and vocoder (16
    -> stages 8, 4) launch the denoiser kernel and the folded MRF kernel,
    once a stage."""
    from mixgantts_tpu_torch import dryrun
    from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator as Gen
    model = dryrun._model("shallow", dryrun.tiny_configs(), cuda)
    vocoder = Gen.from_config(dryrun.TINY_VOCODER, device=cuda)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in dryrun.tiny_batch(2).items()}
    counts = [fn.launches for fn in (fused_residual_stack, mrf_stack, mrf_stack_folded)]
    with torch.no_grad():
        out = model(batch["speakers"], batch["texts"], batch["src_lens"],
                    batch["word_boundaries"], batch["src_w_lens"], max_mel_len=16)
        wav = vocoder(out.mel_pred)
        torch.cuda.synchronize()
    launches = [fn.launches - n for fn, n in
                zip((fused_residual_stack, mrf_stack, mrf_stack_folded), counts)]
    assert launches[0] > 0 and launches[1] == 0 and launches[2] == 2
    assert torch.isfinite(wav).all() and wav.shape == (2, 16 * 16)


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


# Kernel sizes and dilation schedules of the TPU kernels beyond V1's: k in
# {1, 5, 9} alone and with V1's, and schedules at the halo's edge (creeps
# 36, 60, 64, 64, 0) and the widest conv1 reach (k = 3, d = 63: 126 rows of
# halo in a block's tile).
SHAPES = [((1, 5, 9), (1, 3, 5)), ((1, 3, 5, 7, 9, 11), (1, 3, 5)),
          ((3,), (1, 2, 4, 8, 16)), ((11,), (2, 3, 4)), ((9,), (7, 7)),
          ((3,), (15, 15, 15, 15)), ((1,), (1000,)), ((3,), (63,))]


@pytest.mark.parametrize("C", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("kernel_sizes,dilations", SHAPES)
def test_mrf_stack_kernel_at_every_shape(cuda, C, kernel_sizes, dilations):
    """mrf_stack at every odd k and halo schedule, at every width it is
    built for; launches n_br * n_pair (twice that at 512)."""
    x = torch.randn(2, 1000, C, device=cuda, generator=torch.Generator(cuda).manual_seed(C))
    st = kernel_weights(mrf_weights(C, kernel_sizes, n_pair=len(dilations)), kernel_sizes)
    n0 = mrf_stack.launches
    got = mrf_stack(x, st, kernel_sizes, dilations)
    torch.cuda.synchronize()
    assert mrf_stack.launches == n0 + stage_launches(C, len(kernel_sizes), len(dilations))
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes, dilations), BF16_TOL)


@pytest.mark.parametrize("B,T", [(1, 8000), (4, 4096), (2, 37)])
@pytest.mark.parametrize("C", [288, 384, 512])
def test_mrf_stack_kernel_above_256(cuda, C, B, T):
    """C in (256, 512] runs at 512 (blocks of 64 frames own half of the
    output channels; conv1's output through device memory), one branch a
    call as `fused_apply` makes it: six launches a branch."""
    x = torch.randn(B, T, C, device=cuda, generator=torch.Generator(cuda).manual_seed(C + T))
    for ks in [(3,), (7,), (11,)]:
        st = kernel_weights(mrf_weights(C, ks), ks)
        n0 = mrf_stack.launches
        got = mrf_stack(x, st, ks)
        torch.cuda.synchronize()
        assert mrf_stack.launches == n0 + 6
        assert got.shape == x.shape
        assert_close(got, mrf_stack_plain(x, st, ks), BF16_TOL)
    assert tile_frames(512, 11) == 64


def test_mrf_stack_folded_kernel_at_new_kernel_sizes(cuda):
    C, fold, T, ks = 16, 8, 4096, (1, 5, 9)
    x = torch.randn(2, T, C, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    st = dict(kernel_weights(mrf_weights(C, ks, n_pair=2), ks), fold=fold)
    n0 = mrf_stack_folded.launches
    got = mrf_stack_folded(x.reshape(2, T // fold, fold * C), st, ks, (2, 7), prefolded=True)
    torch.cuda.synchronize()
    assert mrf_stack_folded.launches == n0 + 1
    assert_close(got, mrf_stack_plain(x, st, ks, (2, 7)), BF16_TOL)


STREAMED_SHAPES = [((3, 7, 11), (1, 3, 5)), ((1, 5, 9), (1, 3, 5)),
                   ((1, 3, 5, 7, 9, 11), (1, 2)), ((3,), (1, 2, 4, 8, 16)),
                   ((11,), (2, 3, 4)), ((9, 9, 9, 9, 9), (1,)), ((3,), (40,))]


@pytest.mark.parametrize("C", [144, 256, 288, 512])
@pytest.mark.parametrize("kernel_sizes,dilations", STREAMED_SHAPES)
def test_mrf_stack_streamed_kernel_at_every_shape(cuda, C, kernel_sizes, dilations):
    """The whole-stage kernel at 128 < C <= 512 (run at 256 in clusters of
    4, at 512 in clusters of 8), every odd k, more branches and pairs than
    V1's, and halo schedules; one launch."""
    x = torch.randn(2, 1000, C, device=cuda, generator=torch.Generator(cuda).manual_seed(C))
    st = kernel_weights(mrf_weights(C, kernel_sizes, n_pair=len(dilations)), kernel_sizes)
    n0 = mrf_stack_streamed.launches
    got = mrf_stack_streamed(x, st, kernel_sizes, dilations)
    torch.cuda.synchronize()
    assert mrf_stack_streamed.launches == n0 + 1
    assert got.shape == x.shape
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes, dilations), BF16_TOL)


def test_mrf_stack_streamed_plans_every_schedule(cuda):
    """At 256 the widest reach runs passes of two warpgroups; at 512, V1's
    schedule runs passes of one with y in place behind four ring stages,
    and the widest reach (63 frames) passes of one with y out of place
    behind two, and runs."""
    assert streamed_plan(1, 8000)["rows"] == 192
    assert streamed_plan(1, 8000, (3,), (63,))["rows"] == 128
    plan = streamed_plan(1, 8000, C=512)
    assert (plan["rows"], plan["cluster"], plan["stages"], plan["pingpong"]) == (64, 8, 4, 0)
    assert plan["smem"] <= 232448
    plan = streamed_plan(1, 8000, (3,), (63,), C=512)
    assert (plan["rows"], plan["stages"], plan["pingpong"]) == (64, 2, 1)
    assert plan["smem"] == 227456
    x = torch.randn(1, 8000, 512, device=cuda, generator=torch.Generator(cuda).manual_seed(63))
    st = kernel_weights(mrf_weights(512, (3,), n_pair=1), (3,))
    n0 = mrf_stack_streamed.launches
    got = mrf_stack_streamed(x, st, (3,), (63,))
    torch.cuda.synchronize()
    assert mrf_stack_streamed.launches == n0 + 1
    assert_close(got, mrf_stack_plain(x, st, (3,), (63,)), BF16_TOL)


# every single pair at the halo's edge, (k // 2) * (d + 1) <= 64 (conv1
# reaches 63, 62, 60, 60 and 55 frames), and at a reach of 44, one past the
# in-place plan's limit at 512
REACH_PAIRS = [(3, 63), (5, 31), (7, 20), (9, 15), (11, 11), (3, 44), (5, 22), (9, 11)]


@pytest.mark.parametrize("C", [288, 512])
@pytest.mark.parametrize("k,d", REACH_PAIRS)
def test_mrf_stack_streamed_at_the_widest_reaches(cuda, C, k, d):
    """The whole-stage kernel at 512 (288 runs there too) takes every
    single-pair schedule the halo admits, in one launch."""
    x = torch.randn(2, 1000, C, device=cuda, generator=torch.Generator(cuda).manual_seed(k * d))
    st = kernel_weights(mrf_weights(C, (k,), n_pair=1), (k,))
    n0 = mrf_stack_streamed.launches
    got = mrf_stack_streamed(x, st, (k,), (d,))
    torch.cuda.synchronize()
    assert mrf_stack_streamed.launches == n0 + 1
    assert_close(got, mrf_stack_plain(x, st, (k,), (d,)), BF16_TOL)


def test_hifigan_v1_1024_runs_the_wide_kernel(cuda):
    """HiFi-GAN V1 at `upsample_initial_channel` 1024 from a seed: a B=1
    mel at frame bucket 1000 runs the 512 stage on the kernel (one call per
    branch, 18 launches), the 256 and 128 stages (9 each) and the folded 64
    stage (9); its wave stays within the JAX package's bf16 vocoder bar
    (SNR > 30 dB) of the same generator's fp32 plain path on the CPU."""
    torch.manual_seed(3)
    config = dict(V2_CONFIG, upsample_initial_channel=1024)
    gen = HiFiGANGenerator.from_config(config, device="cpu")
    mel = torch.randn(1, 1000, 80, generator=torch.Generator().manual_seed(3)) - 5.0
    with torch.no_grad():
        want = gen(mel)
        gen.to(cuda)
        counts = mrf_stack.launches, mrf_stack_folded.launches
        got = gen(mel.to(cuda))
        torch.cuda.synchronize()
    assert (mrf_stack.launches - counts[0], mrf_stack_folded.launches - counts[1]) == (36, 9)
    got = got.cpu().double()
    snr = 10 * np.log10((want.double() ** 2).mean().item()
                        / ((got - want.double()) ** 2).mean().item())
    assert snr > 30, f"SNR {snr:.1f} dB"


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
    n0 = fused_residual_stack.launches   # every width runs: 544 on the wide route
    fused_residual_stack(*denoiser_inputs(1, 64, C=544, Hc=64, L=2))
    assert fused_residual_stack.launches - n0 == 4
    kw = denoiser_kernel_weights(stacked)
    with pytest.raises(ValueError, match="denoiser_kernel_weights"):
        fused_residual_stack(x, cond, step, dict(kw, out_w_mma=kw["out_w_mma"].float()))
    st = mrf_weights(32, (3,))
    y = torch.randn(1, 32, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_stack(y.transpose(1, 2), st, (3,))
    with pytest.raises(ValueError, match="C <= 512"):   # every narrower width runs
        mrf_stack(torch.randn(1, 64, 544, device=cuda), mrf_weights(544, (3,)), (3,))
    with pytest.raises(ValueError, match="128 < C <= 512"):
        mrf_stack_streamed(torch.randn(1, 64, 128, device=cuda),
                           mrf_weights(128, (3,)), (3,))
    with pytest.raises(ValueError, match="odd k <= 11"):   # the TPU's taps are centred
        mrf_stack(torch.randn(1, 64, 32, device=cuda), mrf_weights(32, (4,)), (4,))
    with pytest.raises(ValueError, match="past the 64-frame halo"):
        mrf_stack(torch.randn(1, 64, 32, device=cuda), mrf_weights(32, (11,), n_pair=4), (11,),
                  (1, 3, 5, 1))
    with pytest.raises(ValueError, match="past the 64-frame halo"):
        mrf_stack_streamed(torch.randn(1, 64, 256, device=cuda), mrf_weights(256, (3,)), (3,),
                           (20, 20, 30))
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


# The whole-stage kernel of the narrow stages (csrc/mrf_stage_narrow.cu,
# C <= 16 in one launch; 16 < C <= 64 stays on the pair kernel, where it is
# faster): every width up to 64 through the route of its width, every odd
# k and schedules at the halo's edge (creep 64 for k = 3 and 5, 60, the most
# a k = 11 branch reaches) at the kernel's widths, B in {1, 4}, T not a
# multiple of the tile and T < 64.
NARROW_WIDTHS = [1, 2, 4, 8, 16, 24, 32, 48, 64]
HALO_EDGE = [((3,), (63,)), ((3,), (1, 2, 4, 8, 16, 27)), ((5,), (31,)), ((5,), (3, 7, 19)),
             ((11,), (2, 3, 4)), ((11,), (11,)), ((3, 5), (31,))]


@pytest.mark.parametrize("B,T", [(1, 3001), (4, 1000), (2, 37)])
@pytest.mark.parametrize("C", NARROW_WIDTHS)
def test_narrow_kernel_matches_plain(cuda, C, B, T):
    """V1's stage at every C <= 64, through both entry points: one launch
    at C <= 16, one per branch and pair above."""
    x = torch.randn(B, T, C, device=cuda, generator=torch.Generator(cuda).manual_seed(C + T))
    st = kernel_weights(mrf_weights(C, (3, 7, 11), seed=C), (3, 7, 11))
    want = mrf_stack_plain(x, st)
    n0 = mrf_stack.launches
    got = mrf_stack(x, st)
    torch.cuda.synchronize()
    assert mrf_stack.launches == n0 + stage_launches(C, 3, 3) and got.shape == x.shape
    assert_close(got, want, BF16_TOL)
    if 128 % C == 0 and T % (128 // C) == 0:
        fold = 128 // C
        n0 = mrf_stack_folded.launches
        got = mrf_stack_folded(x.reshape(B, T // fold, fold * C), dict(st, fold=fold),
                               prefolded=True)
        torch.cuda.synchronize()
        assert mrf_stack_folded.launches == n0 + stage_launches(C, 3, 3)
        assert_close(got, want, BF16_TOL)


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11])
@pytest.mark.parametrize("C", [4, 8, 16])
def test_narrow_kernel_at_every_kernel_size(cuda, C, k):
    """One-branch stages of every odd k <= 11 (V1's dilations)."""
    x = torch.randn(2, 2500, C, device=cuda, generator=torch.Generator(cuda).manual_seed(k))
    st = kernel_weights(mrf_weights(C, (k,), seed=k), (k,))
    got = mrf_stack(x, st, (k,))
    torch.cuda.synchronize()
    assert_close(got, mrf_stack_plain(x, st, (k,)), BF16_TOL)


@pytest.mark.parametrize("C", [4, 8, 16])
@pytest.mark.parametrize("kernel_sizes,dilations", HALO_EDGE)
def test_narrow_kernel_at_the_halo_edge(cuda, C, kernel_sizes, dilations):
    """Schedules whose creep reaches the 64-frame halo, and the widest conv1
    reach (k = 3, d = 63), in one launch."""
    assert max(mrf_ops.creep(k, dilations) for k in kernel_sizes) >= 60
    x = torch.randn(1, 4099, C, device=cuda, generator=torch.Generator(cuda).manual_seed(C))
    st = kernel_weights(mrf_weights(C, kernel_sizes, n_pair=len(dilations)), kernel_sizes)
    n0 = mrf_stack.launches
    got = mrf_stack(x, st, kernel_sizes, dilations)
    torch.cuda.synchronize()
    assert mrf_stack.launches == n0 + 1
    assert_close(got, mrf_stack_plain(x, st, kernel_sizes, dilations), BF16_TOL)


def test_narrow_stages_never_run_the_plain_version(cuda, monkeypatch):
    """On CUDA no stage of C <= 64 reaches the plain version: the kernels'
    counters move (one launch a stage at C <= 16), the plain version's do
    not."""
    plain = []
    for name in ("mrf_stack_plain", "_mrf_stack_plain_bf16"):
        real = getattr(mrf_ops, name)
        monkeypatch.setattr(mrf_ops, name,
                            lambda *a, real=real, name=name, **k: plain.append(name) or real(*a, **k))
    counts = mrf_stack.launches, mrf_stack_folded.launches
    for C in NARROW_WIDTHS:
        x = torch.randn(1, 512, C, device=cuda)
        st = mrf_weights(C, (3, 7, 11))   # fp32: cast per call
        mrf_stack(x, st)
        if 128 % C == 0:
            mrf_stack_folded(x.reshape(1, 512 * C // 128, 128), dict(st, fold=128 // C),
                             prefolded=True)
    torch.cuda.synchronize()
    assert plain == []
    assert mrf_stack.launches - counts[0] == sum(stage_launches(c, 3, 3) for c in NARROW_WIDTHS)
    assert mrf_stack_folded.launches - counts[1] == sum(
        stage_launches(c, 3, 3) for c in NARROW_WIDTHS if 128 % c == 0)


def halo_schedules(k, n_pair):
    """Every schedule of n_pair dilations >= 1 whose creep at kernel size k
    fits the halo."""
    h = max(k // 2, 1)
    if n_pair == 1:
        return [(d,) for d in range(1, HALO // h)]
    return [(d,) + rest for d in range(1, HALO // h)
            for rest in halo_schedules(k, n_pair - 1)
            if (k // 2) * (d + 1 + sum(e + 1 for e in rest)) <= HALO]


def test_narrow_plans_fit_the_card_for_every_schedule(cuda):
    """The library's reckoning (`narrow_smem_bytes`): at both widths, every
    one- and two-pair schedule of every odd k, V1's branches on every
    single-pair schedule that fits the k = 11 branch, and the halo edge
    take at most 232,448 B a block at the longest tile, and the plan at
    HiFi-GAN V2's stage shapes fits too."""
    schedules = [((k,), ds) for k in range(1, 12, 2) for n in (1, 2)
                 for ds in halo_schedules(k, n)]
    schedules += [((3, 7, 11), ds) for ds in halo_schedules(11, 1)] + HALO_EDGE
    for C in (8, 16):
        for ks, ds in schedules:
            smem, tile = narrow_smem_bytes(C, ks, ds)
            assert tile >= 64 and 0 < smem <= MAX_SMEM, (C, ks, ds, smem, tile)
    for C, T in ((16, 128000), (8, 256000), (16, 37), (8, 37)):
        plan = narrow_plan(1, T, C=C)
        assert plan["smem"] <= MAX_SMEM and plan["tile"] <= narrow_smem_bytes(C)[1]
        assert plan["blocks"] == -(-T // plan["tile"])
