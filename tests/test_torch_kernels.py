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
  tile seams, with T not a multiple of the tile, and at B = 2;
- the bf16 arithmetic of the MRF stage (what the TPU kernels compute on
  their chip, and the CUDA kernels on the card): `mrf_stack_plain`,
  `mrf_stack`, `mrf_stack_folded` and `mrf_stack_streamed` with bf16
  stacked weights vs the Pallas kernels in interpret mode with bf16 weights
  on a bf16-exact input.
  Tolerance: max|diff| <= 1e-3 * max|want| + 1e-5 and mean|diff| <= 5e-5 *
  max|want|.  Both sum the same bf16-exact products in fp32, in another
  order; where the two fp32 sums of a conv1 output straddle a bf16 rounding
  boundary its rounded value differs by one bf16 step (2^-8 relative), which
  conv2 spreads to a few outputs: measured up to 3.5e-4 (max) and 1.2e-5
  (mean) of max|want|, the folded layout summing in the most different
  order.  fp32 weights measure at least 1.5e-3 (max) and 3.2e-4 (mean), so
  the cases tell the two arithmetics apart;
- `ops.mrf.kernel_weights`: the bf16 copies in wgmma order that the CUDA
  kernel reads, element for element;
- `models.hifigan.fused_apply` stacks its MRF weights in fp32 on the CPU,
  and in bf16 with the kernel's layout where asked (on CUDA by default);
- the bf16 arithmetic of the denoiser stack: `fused_residual_stack_plain`
  (and the entry point) with bf16 conv_w/out_w vs the Pallas kernel in
  interpret mode with the same weights cast to bf16 and x in fp32, at the
  MRF's bar (max 1e-3, mean 5e-5 of max|want|).  Both round y and g to bf16
  and sum the same bf16-exact products in fp32, in another order; the fp32
  plain version fails the same bar, so the cases tell the arithmetics
  apart.  fp32 weights give exactly what the fp32 plain version gave before
  the bf16 kernel; `denoiser_kernel_weights` lays out each CTA's columns in
  wgmma's order, element for element; `models.denoiser.Denoiser` stacks
  fp32 on the CPU and bf16 where `stack_dtype` asks;
- bf16 activations (a model computing in bf16): the MRF entry points and
  the denoiser stack fed bf16 signals, weights and biases against the
  Pallas kernels in interpret mode on the same bf16 values, outputs in
  bf16 on both sides: max |diff| <= 2^-7 and mean <= 2^-10 of max|want|
  (two bf16 steps: the output's rounding, and the hoisted projections,
  which JAX rounds after the product and again after the bias and the
  port once);
- the speaker term of a multi-speaker denoiser joins the conditioner
  projection, per batch row, and never the residual.

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
from mixgantts_tpu_torch.models.denoiser import Denoiser as TDenoiser
from mixgantts_tpu_torch.models.hifigan import HiFiGANGenerator
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


DENOISER_CASES = [
    (1, 70, 3, 16, 24, 32),    # three tiles, the last one short
    (2, 9, 2, 8, 8, None),     # one short tile
    (2, 50, 4, 32, 48, None),  # one tile
]


@pytest.mark.parametrize("B,T,L,C,Hc,tile", DENOISER_CASES)
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


def bf16_exact(x):
    """x rounded to bf16 and back: an input the bf16 and fp32 paths read
    alike (the TPU kernel rounds its x tiles to bf16; interpret mode does
    not)."""
    return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)


def with_bf16_weights(st):
    return dict(st, w1=st["w1"].astype(jnp.bfloat16), w2=st["w2"].astype(jnp.bfloat16))


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 1e-3 * scale + 1e-5, f"max|diff| {err.max():.3g}, max|want| {scale:.3g}"
    assert err.mean() <= 5e-5 * scale, f"mean|diff| {err.mean():.3g}, max|want| {scale:.3g}"


@pytest.mark.parametrize("C,T,B,rks,tile", [
    (16, 103, 2, (3, 7, 11), 56),   # tile seams and a ragged last tile
    (16, 40, 1, (11,), None),       # one branch, as the C = 256 stage runs
    (128, 40, 1, (3,), None),       # the C = 128 boundary
])
def test_mrf_stack_bf16_matches_pallas_bf16(C, T, B, rks, tile):
    x, params = mrf_case(C, T, B, rks, seed=C + T)
    x = bf16_exact(x)
    st = jvoc.stack_mrf_params(params, 0, rks)
    want = jvoc.mrf_stack(x, with_bf16_weights(st), rks, tile=tile, interpret=True)
    weights = tmrf.kernel_weights(as_torch(st), rks)
    xt = torch.as_tensor(np.asarray(x))
    for fn in (tmrf.mrf_stack_plain, tmrf.mrf_stack):
        assert_bf16_close(fn(xt, weights, rks), want)
    with pytest.raises(AssertionError):   # the fp32 arithmetic is another result
        assert_bf16_close(tmrf.mrf_stack_plain(xt, as_torch(st), rks), want)


@pytest.mark.parametrize("B,T,tile", [
    (2, 100, 48),    # two seams, a ragged last tile, two batch rows
    (1, 40, None),   # one tile
])
def test_mrf_stack_streamed_bf16_matches_pallas_bf16(B, T, tile):
    C, rks = 256, (3, 7, 11)
    x, params = mrf_case(C, T, B, rks, seed=T)
    x = bf16_exact(x)
    st = jvoc.stack_mrf_params(params, 0, rks)
    want = jvoc.mrf_stack_streamed(x, with_bf16_weights(st), rks, tile=tile, interpret=True)
    xt = torch.as_tensor(np.asarray(x))
    got = tmrf.mrf_stack_streamed(xt, tmrf.kernel_weights(as_torch(st), rks), rks)
    assert tmrf.mrf_stack_streamed.launches == 0   # the CPU runs the plain version
    assert_bf16_close(got, want)
    with pytest.raises(AssertionError):   # the fp32 arithmetic is another result
        assert_bf16_close(tmrf.mrf_stack_streamed(xt, as_torch(st), rks), want)


@pytest.mark.parametrize("fold,tile", [(2, None), (4, 32)])
def test_mrf_stack_folded_bf16_matches_pallas_bf16(fold, tile):
    C, T, B = 16, 96, 2
    x, params = mrf_case(C, T, B, (3, 7, 11), seed=fold)
    xf = bf16_exact(x).reshape(B, T // fold, fold * C)
    want = jvoc.mrf_stack_folded(
        xf, with_bf16_weights(jvoc.stack_mrf_params_folded(params, 0, fold)), tile=tile,
        interpret=True, prefolded=True)
    st = dict(tmrf.kernel_weights(as_torch(jvoc.stack_mrf_params(params, 0))), fold=fold)
    got = tmrf.mrf_stack_folded(torch.as_tensor(np.asarray(xf)), st, prefolded=True)
    assert got.shape == (B, T, C)
    assert_bf16_close(got, want)


def assert_bf16_outputs_close(got, want):
    """Both sides in bf16 (bf16 activations in, the output in x's type):
    max|diff| within two bf16 steps of max|want| (2^-7: the output's own
    rounding, plus the hoisted projections, which the JAX package rounds
    twice, product then sum with the bias, and the port once) and mean
    |diff| within 2^-10 of it."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 2 ** -7 * scale, f"max|diff| {err.max():.3g}, max|want| {scale:.3g}"
    assert err.mean() <= 2 ** -10 * scale, f"mean|diff| {err.mean():.3g}, max|want| {scale:.3g}"


@pytest.mark.parametrize("fold", [None, 4])
def test_mrf_stack_bf16_activations_match_pallas(fold):
    """bf16 signal and bf16 weights and biases (what the TPU kernels read
    under the JAX package's bf16 compute) against the Pallas kernels in
    interpret mode on the same bf16 values; the output in bf16."""
    C, T, B, rks = 16, 96, 2, (3, 7, 11)
    x, params = mrf_case(C, T, B, rks, seed=11)
    x16 = x.astype(jnp.bfloat16)
    st16 = {k: v.astype(jnp.bfloat16) for k, v in jvoc.stack_mrf_params(params, 0, rks).items()}
    port_st = as_torch({k: v.astype(jnp.float32) for k, v in st16.items()})
    port_st = {k: v.bfloat16() for k, v in port_st.items()}
    xt = torch.as_tensor(np.asarray(x16.astype(jnp.float32))).bfloat16()
    if fold is None:
        want = jvoc.mrf_stack(x16, st16, rks, interpret=True)
        for fn in (tmrf.mrf_stack_plain, tmrf.mrf_stack):
            assert_bf16_outputs_close(fn(xt, port_st, rks), want)
    else:
        folded = jvoc.stack_mrf_params_folded(params, 0, fold)
        folded = {k: v if k == "fold" else v.astype(jnp.bfloat16) for k, v in folded.items()}
        want = jvoc.mrf_stack_folded(x16.reshape(B, T // fold, fold * C), folded, rks,
                                     interpret=True, prefolded=True)
        got = tmrf.mrf_stack_folded(xt.reshape(B, T // fold, fold * C), dict(port_st, fold=fold),
                                    rks, prefolded=True)
        assert_bf16_outputs_close(got, want.reshape(B, T, C))


def test_denoiser_stack_bf16_activations_match_pallas():
    """bf16 x, cond and step embedding with every stacked weight in bf16
    (the JAX package's bf16 compute) against the Pallas kernel in interpret
    mode on the same values; the outputs in bf16."""
    x, cond, step, stacked = denoiser_case(2, 50, 4, 32, 48, seed=3)
    low = {k: v.astype(jnp.bfloat16) for k, v in stacked.items()}
    args16 = [a.astype(jnp.bfloat16) for a in (x, cond, step)]
    want = jpallas.fused_residual_stack(*args16, low, interpret=True)
    args = [torch.as_tensor(np.asarray(a.astype(jnp.float32))).bfloat16() for a in args16]
    weights = {k: torch.as_tensor(np.asarray(v.astype(jnp.float32))).bfloat16()
               for k, v in low.items()}
    for fn in (tden.fused_residual_stack_plain, tden.fused_residual_stack):
        for got, w in zip(fn(*args, weights), want):
            assert_bf16_outputs_close(got, w)


def test_denoiser_stack_speaker_term_joins_the_conditioner():
    """The speaker term spk_proj [L, B, C] is added where the conditioner
    projection's bias is, per batch row, and never to the residual: the
    stack with it equals, row by row, the stack whose cond_b carries that
    row's term (fp32 and bf16 weights; the entry point on the CPU too)."""
    B, T, L, C, Hc = 2, 30, 3, 16, 24
    x, cond, step, stacked = denoiser_case(B, T, L, C, Hc, seed=5)
    x, cond, step = _torch_args(x, cond, step)
    spk = torch.as_tensor(np.random.RandomState(5).randn(L, B, C).astype(np.float32))
    for st in (as_torch(stacked), tden.denoiser_kernel_weights(as_torch(stacked))):
        got = tden.fused_residual_stack(x, cond, step, st, spk)
        for b in range(B):
            want = tden.fused_residual_stack_plain(
                x[b:b + 1], cond[b:b + 1], step[b:b + 1], dict(st, cond_b=st["cond_b"] + spk[:, b]))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[b].numpy(), w[0].numpy(), rtol=1e-5, atol=1e-5)
        moved = tden.fused_residual_stack_plain(x, cond, step, st)
        assert (moved[1] - got[1]).abs().max() > 1e-2


def _mrf_stack_plain_fp32_reference(x, stacked, kernel_sizes, dilations):
    """The fp32 plain version as it stood before the bf16 kernel (kept
    here verbatim: fp32 weights must keep giving exactly this)."""
    import torch.nn.functional as F
    xt = x.transpose(1, 2)
    acc = None
    for br, rk in enumerate(kernel_sizes):
        pad = (tmrf.TAPS - rk) // 2
        y = xt
        for p, d in enumerate(dilations):
            w1 = stacked["w1"][br, p, pad:tmrf.TAPS - pad].permute(2, 1, 0)
            w2 = stacked["w2"][br, p, pad:tmrf.TAPS - pad].permute(2, 1, 0)
            t = F.leaky_relu(y, tmrf.LRELU_SLOPE)
            t = F.conv1d(t, w1, stacked["b1"][br, p], dilation=d,
                         padding=d * (rk - 1) // 2)
            t = F.leaky_relu(t, tmrf.LRELU_SLOPE)
            t = F.conv1d(t, w2, stacked["b2"][br, p], padding=(rk - 1) // 2)
            y = y + t
        acc = y if acc is None else acc + y
    return (acc / len(kernel_sizes)).transpose(1, 2)


@pytest.mark.parametrize("rks", [(3, 7, 11), (7,)])
def test_mrf_stack_plain_fp32_is_unchanged(rks):
    x, params = mrf_case(16, 70, 2, rks, seed=5)
    st = as_torch(jvoc.stack_mrf_params(params, 0, rks))
    xt = torch.as_tensor(np.asarray(x))
    want = _mrf_stack_plain_fp32_reference(xt, st, rks, (1, 3, 5))
    assert torch.equal(tmrf.mrf_stack_plain(xt, st, rks), want)


@pytest.mark.parametrize("C,rks", [(32, (3, 7, 11)), (64, (11,))])
def test_kernel_weights_are_in_wgmma_order(C, rks):
    """Element (K = tap * C + c_in, c_out) of each (branch, pair) sits where
    the kernel's descriptor reads it: 16-deep slab s, 8-channel group g,
    K half h, core-matrix row c_out % 8, column K % 8."""
    r = np.random.RandomState(C)
    n_br = len(rks)
    w = np.zeros((n_br, 3, tmrf.TAPS, C, C), np.float32)
    for br, k in enumerate(rks):
        pad = (tmrf.TAPS - k) // 2
        w[br, :, pad:pad + k] = r.randn(3, k, C, C)
    st = {"w1": torch.tensor(w), "w2": torch.tensor(-w),
          "b1": torch.zeros(n_br, 3, C), "b2": torch.zeros(n_br, 3, C)}
    kw = tmrf.kernel_weights(st, rks)
    assert kw["w1"].dtype == kw["w2"].dtype == torch.bfloat16
    assert kw["w1_mma"].shape == (n_br, 3, tmrf.TAPS * C * C)
    for br, k in enumerate(rks):
        pad = (tmrf.TAPS - k) // 2
        kk, n = np.meshgrid(np.arange(k * C), np.arange(C), indexing="ij")
        at = (((kk // 16) * (C // 8) + n // 8) * 2 + (kk % 16) // 8) * 64 + (n % 8) * 8 + kk % 8
        for key in ("w1", "w2"):
            dense = kw[key][br, :, pad:pad + k].reshape(3, k * C, C)
            assert torch.equal(kw[key + "_mma"][br][:, torch.as_tensor(at)], dense)


def test_fused_apply_stacks_fp32_on_the_cpu_and_bf16_where_asked():
    """On the CPU the MRF weights stay fp32 (the plain fp32 path); with
    mrf_dtype = bf16 (the default on CUDA) they are stacked once per stage
    in bf16 with the kernel's layout, and the waveform stays within the JAX
    package's bar for its bf16 vocoder (SNR > 30 dB against fp32)."""
    torch.manual_seed(0)
    gen = HiFiGANGenerator(n_mels=20, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                           upsample_initial_channel=64, device="cpu")
    mel = torch.tensor(np.random.RandomState(0).randn(1, 12, 20), dtype=torch.float32)
    with torch.no_grad():
        ref = gen(mel)
        assert {key[2] for key in gen._stacked} == {torch.float32}
        assert all(st["w1"].dtype == torch.float32 and "w1_mma" not in st
                   for st in gen._stacked.values())
        gen.mrf_dtype = torch.bfloat16
        low = gen(mel)
        assert gen(mel).equal(low)
    bf16 = [st for key, st in gen._stacked.items() if key[2] == torch.bfloat16]
    assert len(bf16) == 2 and all(
        st["w1"].dtype == torch.bfloat16 and st["w1_mma"].dtype == torch.bfloat16
        for st in bf16)
    snr = 10 * np.log10((ref ** 2).mean().item() / ((ref - low) ** 2).mean().item())
    assert 30 < snr < 120, f"bf16 MRF SNR {snr:.1f} dB"


def _torch_args(x, cond, step):
    return (torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(cond)),
            torch.as_tensor(np.asarray(step)))


@pytest.mark.parametrize("B,T,L,C,Hc,tile", DENOISER_CASES)
def test_denoiser_stack_bf16_matches_pallas_bf16(B, T, L, C, Hc, tile):
    x, cond, step, stacked = denoiser_case(B, T, L, C, Hc, seed=T)
    low = dict(stacked, conv_w=stacked["conv_w"].astype(jnp.bfloat16),
               out_w=stacked["out_w"].astype(jnp.bfloat16))
    want = jpallas.fused_residual_stack(x, cond, step, low, tile=tile, interpret=True)
    args = _torch_args(x, cond, step)
    weights = tden.denoiser_kernel_weights(as_torch(stacked))
    for fn in (tden.fused_residual_stack_plain, tden.fused_residual_stack):
        for got, w in zip(fn(*args, weights), want):
            assert_bf16_close(got, w)
    with pytest.raises(AssertionError):   # the fp32 arithmetic is another result
        for got, w in zip(tden.fused_residual_stack_plain(*args, as_torch(stacked)), want):
            assert_bf16_close(got, w)


def _fused_residual_stack_plain_fp32_reference(x, cond, step_emb, stacked):
    """The fp32 plain version as it stood before the bf16 kernel (kept here
    verbatim: fp32 weights must keep giving exactly this)."""
    import math
    import torch.nn.functional as F
    step_proj = torch.einsum("bc,lcd->lbd", step_emb, stacked["step_w"]).contiguous()
    condp = torch.einsum("bth,lhc->lbtc", cond, stacked["cond_w"])
    condp = (condp + stacked["cond_b"][:, None, None, :]).contiguous()
    C = x.shape[-1]
    skip = torch.zeros_like(x)
    for l in range(stacked["conv_w"].shape[0]):
        y0 = x + step_proj[l][:, None, :]
        y = y0 + condp[l]
        z = F.conv1d(y.transpose(1, 2), stacked["conv_w"][l].permute(2, 1, 0),
                     stacked["conv_b"][l], padding=1).transpose(1, 2)
        g = torch.sigmoid(z[..., :C]) * torch.tanh(z[..., C:])
        o = g @ stacked["out_w"][l] + stacked["out_b"][l]
        x = (o[..., :C] + y0) * (1.0 / math.sqrt(2.0))
        skip = skip + o[..., C:]
    return x, skip


@pytest.mark.parametrize("B,T,L,C,Hc,tile", DENOISER_CASES)
def test_denoiser_stack_plain_fp32_is_unchanged(B, T, L, C, Hc, tile):
    x, cond, step, stacked = denoiser_case(B, T, L, C, Hc, seed=T + 1)
    args = _torch_args(x, cond, step)
    got = tden.fused_residual_stack_plain(*args, as_torch(stacked))
    want = _fused_residual_stack_plain_fp32_reference(*args, as_torch(stacked))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("C", [64, 128])
def test_denoiser_kernel_weights_are_in_wgmma_order(C):
    """Column n of CTA `rank`'s B operand is gate (or x') column 32 rank + n
    for n < 32 and filter (or skip) column C + 32 rank + n - 32 above; its
    element (K, n) sits where the kernel's descriptor reads it: 16-deep slab
    s, 8-column group g, K half h, core-matrix row n % 8, column K % 8.  The
    conditioner projection's weights lie side by side, layer after layer."""
    r = np.random.RandomState(C)
    L, Hc = 2, 24
    st = {"conv_w": torch.tensor(r.randn(L, 3, C, 2 * C), dtype=torch.float32),
          "out_w": torch.tensor(r.randn(L, C, 2 * C), dtype=torch.float32),
          "cond_w": torch.tensor(r.randn(L, Hc, C), dtype=torch.float32),
          "cond_b": torch.tensor(r.randn(L, C), dtype=torch.float32),
          "conv_b": torch.zeros(L, 2 * C), "out_b": torch.zeros(L, 2 * C)}
    kw = tden.denoiser_kernel_weights(st)
    assert kw["conv_w"].dtype == kw["out_w"].dtype == torch.bfloat16
    # the conditioner projection side by side: condp[b, t, l, c] in one product
    assert torch.equal(kw["cond_w_cat"].reshape(Hc, L, C), st["cond_w"].permute(1, 0, 2))
    assert torch.equal(kw["cond_b_cat"].reshape(L, C), st["cond_b"])
    ranks = C // tden.GROUP
    for key, K in (("conv_w", 3 * C), ("out_w", C)):
        packed = kw[key + "_mma"]
        assert packed.dtype == torch.bfloat16 and packed.shape == (L, ranks, K * 64)
        dense = kw[key].reshape(L, K, 2 * C)
        kk, n = np.meshgrid(np.arange(K), np.arange(64), indexing="ij")
        at = (((kk // 16) * 8 + n // 8) * 2 + (kk % 16) // 8) * 64 + (n % 8) * 8 + kk % 8
        for rank in range(ranks):
            col = np.where(n < 32, 32 * rank + n, C + 32 * rank + n - 32)
            assert torch.equal(packed[:, rank][:, torch.as_tensor(at)],
                               dense[:, torch.as_tensor(kk), torch.as_tensor(col)])


def test_denoiser_stacks_fp32_on_the_cpu_and_bf16_where_asked():
    """On the CPU the denoiser stacks fp32 weights (the plain fp32 path);
    with stack_dtype = bf16 (the default on CUDA) it stacks them once in
    bf16 with the kernel's layout, computes the bf16 arithmetic, and stays
    within the JAX package's bar for its bf16 denoiser (mean |diff| < 2% of
    max|fp32|, tests/test_pallas.py)."""
    torch.manual_seed(0)
    den = TDenoiser(n_mels=20, d_encoder=24, residual_channels=32, residual_layers=3)
    with torch.no_grad():
        den.output_projection.conv.weight.normal_(0, 0.1)
    r = np.random.RandomState(0)
    x_t = torch.tensor(r.randn(2, 30, 20), dtype=torch.float32)
    t = torch.tensor([0, 3])
    cond = torch.tensor(r.randn(2, 30, 24), dtype=torch.float32)
    with torch.no_grad():
        ref = den(x_t, t, cond)
        st = den.stacked()
        assert st["conv_w"].dtype == torch.float32 and "conv_w_mma" not in st
        den.stack_dtype = torch.bfloat16
        low = den(x_t, t, cond)
        st16 = den.stacked()
        assert st16["conv_w"].dtype == torch.bfloat16 and "conv_w_mma" in st16
        assert den.stacked() is st16 and den(x_t, t, cond).equal(low)
        den.stack_dtype = None
        assert den.stacked()["conv_w"].dtype == torch.float32
    err = (low - ref).abs().mean().item() / ref.abs().max().item()
    assert 0 < err < 0.02, f"bf16 denoiser mean|diff| {err:.3g} of max|fp32|"
    with pytest.raises(ValueError, match="stack_dtype"):
        den.stack_dtype = torch.float16
        den.stacked()
