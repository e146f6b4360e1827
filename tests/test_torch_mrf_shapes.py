"""The MRF stage at every shape the TPU kernels take, here on the CPU.

The JAX package's Pallas kernels (`mrf_stack`, `mrf_stack_folded`,
`mrf_stack_streamed`) take every odd kernel size up to TAPS = 11, any number
of branches and pairs, any dilation schedule whose creep, sum over pairs of
(k // 2) * (d + 1), fits their 64-frame halo, and any width.  The port's
CUDA kernels take the same shapes up to C = 512 (`ops.mrf`); what the card
computes is the plain version (`mrf_stack_plain`) on those shapes, at the
kernel's width with zero channels.  These cases hold, on the CPU:

- the plain version against each Pallas kernel in interpret mode, at
  k in {1, 5, 9} alone and mixed with V1's, and at dilation schedules at
  the halo's edge, with T longer than the JAX tile so that the halo
  matters: fp32 arithmetic at test_pallas.py's rtol 1e-4 and atol 1e-5;
  bf16 arithmetic (bf16 weights, a bf16-exact input) at max |diff| <=
  2^-8 max|want| + 1e-5, one bf16 step of the largest value (the bar the
  GPU kernels are held to against this plain version, for the same
  reason), and mean |diff| <= 2^-12 max|want|.  Both sum the same
  bf16-exact products in fp32 in another order; where a conv input's two
  sums straddle a bf16 rounding boundary they differ by one bf16 step, and
  every later pair of the one-branch chain carries that on and flips more
  (measured: 2e-7 of max|want| at most shapes, where no rounding flipped;
  up to 1.8e-3 (max) and 1.1e-4 (mean) where one did, on 2% to 71% of the
  outputs; the fp32 arithmetic sits at 1.3e-3 to 4.1e-3 (max) and 2.6e-4
  to 6.8e-4 (mean) from the same JAX outputs, on every output);
- at C in {288, 384, 512}, the stage run at the kernel's width (512) with
  zero channels and cut back equals the unpadded stage within 1e-6 of
  max|unpadded|, in fp32 and bf16 arithmetic; so do the whole-stage
  kernel's widths (256 and 512);
- `_pack_taps` at k in {1, 5, 9}, at C = 32 and at C = 512 (the layout
  split into runs of 256 output channels), element for element;
- `_check` takes every odd k <= 11 and every schedule within the halo, and
  names what it does not take (an even k, a schedule past the halo,
  C = 513);
- HiFi-GAN V1 with `upsample_initial_channel` 1024 (stages 512, 256, 128,
  64) at a tiny T, on weights bridged by `convert.py`: the port's
  `fused_apply` against the JAX `fused_apply` in interpret mode (rtol 1e-4,
  atol 1e-5), the 512 stage one call per branch, as the JAX package runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.models.hifigan import convert_torch_generator
from mixgantts_tpu.models.hifigan import fused_apply as j_fused_apply
from mixgantts_tpu.ops import pallas_vocoder as jvoc
from mixgantts_tpu_torch.models import hifigan as thifigan
from mixgantts_tpu_torch.ops import mrf as tmrf
from test_torch_gpu_kernels import mrf_weights
from test_torch_mrf_widths import flax_stage_params, padded_stage
from torch_port_helpers import assert_close, t, torch_hifigan_like

V1_KS, V1_DILS = (3, 7, 11), (1, 3, 5)
# (kernel sizes, dilations, T): k in {1, 5, 9} alone and mixed with V1's,
# then schedules at the halo's edge (creeps 36, 60, 64, 64, 64 and 0, 63)
SHAPES = [
    ((1,), V1_DILS, 112),
    ((5,), V1_DILS, 112),
    ((9,), V1_DILS, 112),
    ((1, 3, 5, 7, 9, 11), V1_DILS, 112),
    ((3,), (1, 2, 4, 8, 16), 160),
    ((11,), (2, 3, 4), 160),
    ((3,), (15, 15, 15, 15), 160),
    ((9,), (7, 7), 160),
    ((5, 1), (15, 15), 160),
    ((7, 3), (6, 13), 160),
]
SHAPE_IDS = ["k1", "k5", "k9", "k1-11", "k3-d1,2,4,8,16", "k11-d2,3,4", "k3-d15x4", "k9-d7,7",
             "k5,1-d15,15", "k7,3-d6,13"]
ARITHMETIC = ["fp32", "bf16"]


def stage_case(C, kernel_sizes, dilations, T, B=2, seed=0):
    """x [B, T, C] and stacked weights from numpy, as torch and JAX arrays."""
    st = mrf_weights(C, kernel_sizes, n_pair=len(dilations), seed=seed, device="cpu")
    x = np.random.RandomState(seed + 1).randn(B, T, C).astype(np.float32)
    return x, st, {k: jnp.asarray(v.numpy()) for k, v in st.items()}


def as_arithmetic(arithmetic, x, st, jst, kernel_sizes):
    """(x, port weights, JAX weights) in the arithmetic asked: bf16 is bf16
    weights (`kernel_weights`, the kernels' operand type; the JAX weights'
    w1 and w2, any layout) on a bf16-exact x, which the TPU kernel's
    rounding of its x tiles leaves alone."""
    if arithmetic == "fp32":
        return x, st, jst
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x, tmrf.kernel_weights(st, kernel_sizes), dict(
        jst, w1=jst["w1"].astype(jnp.bfloat16), w2=jst["w2"].astype(jnp.bfloat16))


def assert_matches(arithmetic, got, want):
    if arithmetic == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        return
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 2 ** -8 * scale + 1e-5, f"max|diff| {err.max():.3g}, max|want| {scale:.3g}"
    assert err.mean() <= 2 ** -12 * scale, f"mean|diff| {err.mean():.3g}, max|want| {scale:.3g}"


@pytest.mark.parametrize("arithmetic", ARITHMETIC)
@pytest.mark.parametrize("kernel_sizes,dilations,T", SHAPES, ids=SHAPE_IDS)
def test_mrf_stack_shapes_match_pallas(kernel_sizes, dilations, T, arithmetic):
    x, st, jst = stage_case(16, kernel_sizes, dilations, T, seed=T + len(kernel_sizes))
    x, st, jst = as_arithmetic(arithmetic, x, st, jst, kernel_sizes)
    want = jvoc.mrf_stack(jnp.asarray(x), jst, kernel_sizes, dilations, tile=48,
                          interpret=True)
    xt = torch.from_numpy(x.copy())
    for fn in (tmrf.mrf_stack_plain, tmrf.mrf_stack):   # the CPU runs the plain version
        assert_matches(arithmetic, fn(xt, st, kernel_sizes, dilations), want)


FOLDED = [0, 3, 6, 8]      # SHAPES indices: k1-11, and three halo edges
STREAMED = [2, 4, 5, 9]
# the whole-stage kernel's widest conv1 reaches, (k // 2) * d of 63, 62, 55
# and 62 (creeps 64, 64, 60 and 64, 32): the plans that run y out of place
REACH_EDGES = [((3,), (63,), 160), ((5,), (31,), 160), ((11,), (11,), 160),
               ((5, 3), (31,), 160)]
REACH_IDS = ["k3-d63", "k5-d31", "k11-d11", "k5,3-d31"]


@pytest.mark.parametrize("arithmetic", ARITHMETIC)
@pytest.mark.parametrize("kernel_sizes,dilations,T", [SHAPES[i] for i in FOLDED],
                         ids=[SHAPE_IDS[i] for i in FOLDED])
def test_mrf_stack_folded_shapes_match_pallas(kernel_sizes, dilations, T, arithmetic):
    """The folded entry point (C = 16, F = 8) against the TPU's folded
    kernel, three 64-frame tiles."""
    C, fold, B = 16, 8, 2
    x, st, _ = stage_case(C, kernel_sizes, dilations, T, seed=T)
    folded = jvoc.stack_mrf_params_folded(flax_stage_params(st, kernel_sizes), 0, fold,
                                          kernel_sizes, dilations)
    x, st, folded = as_arithmetic(arithmetic, x, st, folded, kernel_sizes)
    xf = x.reshape(B, T // fold, fold * C)   # contiguous == folded layout
    want = jvoc.mrf_stack_folded(jnp.asarray(xf), folded, kernel_sizes, dilations, tile=64,
                                 interpret=True, prefolded=True)
    got = tmrf.mrf_stack_folded(torch.from_numpy(xf.copy()), dict(st, fold=fold), kernel_sizes,
                                dilations, prefolded=True)
    assert got.shape == (B, T, C)
    assert_matches(arithmetic, got, np.asarray(want).reshape(B, T, C))


@pytest.mark.parametrize("arithmetic", ARITHMETIC)
@pytest.mark.parametrize("kernel_sizes,dilations,T", [SHAPES[i] for i in STREAMED] + REACH_EDGES,
                         ids=[SHAPE_IDS[i] for i in STREAMED] + REACH_IDS)
def test_mrf_stack_streamed_shapes_match_pallas(kernel_sizes, dilations, T, arithmetic):
    """The whole-stage entry point at C = 144 (run at 256 on the card)
    against the TPU's streamed kernel, tiles of 48 frames."""
    x, st, jst = stage_case(144, kernel_sizes, dilations, T, B=1, seed=T)
    x, st, jst = as_arithmetic(arithmetic, x, st, jst, kernel_sizes)
    want = jvoc.mrf_stack_streamed(jnp.asarray(x), jst, kernel_sizes, dilations, tile=48,
                                   interpret=True)
    got = tmrf.mrf_stack_streamed(torch.from_numpy(x.copy()), st, kernel_sizes, dilations)
    assert tmrf.mrf_stack_streamed.launches == 0   # the CPU runs the plain version
    assert_matches(arithmetic, got, want)


def streamed_padded_stage(x, st, kernel_sizes, dilations):
    """The stage as the whole-stage kernel's route computes it, in plain
    PyTorch: at `streamed_width(C)` with zero channels, cut back to C."""
    C = x.shape[-1]
    Cp = tmrf.streamed_width(C)
    out = tmrf.mrf_stack_plain(tmrf.pad_channels(x, Cp), tmrf.pad_mrf_width(st, Cp),
                               kernel_sizes, dilations)
    assert out.shape[-1] == Cp and torch.count_nonzero(out[..., C:]) == 0
    return out[..., :C]


@pytest.mark.parametrize("arithmetic", ARITHMETIC)
@pytest.mark.parametrize("C", [288, 384, 512])
def test_wide_padded_stage_equals_unpadded(C, arithmetic):
    """One branch a call, as `fused_apply` makes it above 128: at the
    kernel's width 512 and at the whole-stage kernel's (512), padded and
    cut back, against the stage at C."""
    ks = (7,)
    st = mrf_weights(C, ks, seed=C, device="cpu")
    if arithmetic == "bf16":
        st = tmrf.kernel_weights(st, ks)
        assert st["w1_mma"].shape == (1, 3, tmrf.TAPS * 512 * 512)
    x = torch.tensor(np.random.RandomState(C + 1).randn(1, 40, C), dtype=torch.float32)
    want = tmrf.mrf_stack_plain(x, st, ks)
    assert tmrf.kernel_width(C) == tmrf.streamed_width(C) == 512
    for got in (padded_stage(x, st, ks), streamed_padded_stage(x, st, ks, V1_DILS)):
        err = (got - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), err


def test_streamed_width_takes_every_stage_above_128():
    assert [tmrf.streamed_width(c) for c in (129, 144, 256, 257, 384, 512)] == [
        256, 256, 256, 512, 512, 512]
    for C in (128, 513):
        with pytest.raises(ValueError, match="128 < C <= 512"):
            tmrf.streamed_width(C)
    x = torch.tensor(np.random.RandomState(3).randn(1, 30, 144), dtype=torch.float32)
    st = mrf_weights(144, V1_KS, seed=3, device="cpu")
    got = streamed_padded_stage(x, st, V1_KS, V1_DILS)
    want = tmrf.mrf_stack_plain(x, st, V1_KS, V1_DILS)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    assert [tmrf.pair_launches(c) for c in (32, 256, 257, 512)] == [1, 1, 2, 2]


def unpack_taps(packed, kernel_sizes, C):
    """`w1_mma`/`w2_mma` [n_br, n_pair, 11 C C] back to dense [n_br, n_pair,
    11, C, C]: per run z of min(C, 256) output channels, per 16-deep K slab,
    per group of 8 output channels, per half of the slab, an 8 x 8 core
    matrix (the inverse of `ops.mrf._pack_taps`)."""
    n_br, n_pair, _ = packed.shape
    n = min(C, tmrf.SPLIT)
    dense = torch.zeros(n_br, n_pair, tmrf.TAPS, C, C, dtype=packed.dtype)
    for br, k in enumerate(kernel_sizes):
        pad = (tmrf.TAPS - k) // 2
        kk, c_out = np.meshgrid(np.arange(k * C), np.arange(C), indexing="ij")
        z, c = c_out // n, c_out % n
        at = (z * k * C * n + (((kk // 16) * (n // 8) + c // 8) * 2 + (kk % 16) // 8) * 64
              + (c % 8) * 8 + kk % 8)
        dense[br, :, pad:pad + k] = packed[br][:, torch.as_tensor(at)].reshape(n_pair, k, C, C)
    return dense


@pytest.mark.parametrize("C", [32, 512])
def test_pack_taps_at_every_new_kernel_size(C):
    ks = (1, 5, 9)
    st = mrf_weights(C, ks, n_pair=1, seed=C, device="cpu")
    kw = tmrf.kernel_weights(st, ks)
    for key in ("w1", "w2"):
        assert kw[key + "_mma"].shape == (3, 1, tmrf.TAPS * C * C)
        assert torch.equal(unpack_taps(kw[key + "_mma"], ks, C), kw[key])
        for br, k in enumerate(ks):   # the taps past k stay zero
            assert torch.count_nonzero(kw[key + "_mma"][br, :, k * C * C:]) == 0


def check_args(C, kernel_sizes, dilations):
    st = {k: torch.zeros(len(kernel_sizes), len(dilations), *s) for k, s in (
        ("w1", (tmrf.TAPS, C, C)), ("w2", (tmrf.TAPS, C, C)), ("b1", (C,)), ("b2", (C,)))}
    return torch.zeros(1, 8, C), st, tuple(kernel_sizes), tuple(dilations)


# every odd k, each at a schedule whose creep is the most the halo holds
EDGE_SCHEDULES = [((1,), (1000,)), ((3,), (63,)), ((5,), (31,)), ((7,), (20,)),
                  ((9,), (15,)), ((11,), (11,)), ((11,), (1, 3, 5)),
                  ((3,), (15, 15, 15, 15)), ((1, 3, 5, 7, 9, 11), (1, 2))]


@pytest.mark.parametrize("kernel_sizes,dilations", EDGE_SCHEDULES)
def test_check_takes_every_odd_k_within_the_halo(kernel_sizes, dilations):
    assert all(tmrf.creep(k, dilations) <= tmrf.HALO for k in kernel_sizes)
    tmrf._check("mrf_stack", *check_args(32, kernel_sizes, dilations))


@pytest.mark.parametrize("C,kernel_sizes,dilations,message", [
    (32, (4,), (1,), r"odd k <= 11"),
    (32, (3, 13), (1,), r"odd k <= 11"),
    (32, (3,), (0,), r"integers >= 1"),
    (32, (11,), (1, 3, 5, 1), r"creeps 70 frames a side, past the 64-frame halo"),
    (32, (3,), (64,), r"creeps 65 frames a side, past the 64-frame halo"),
    (513, (3,), (1,), r"C <= 512"),
])
def test_check_names_what_it_does_not_take(C, kernel_sizes, dilations, message):
    with pytest.raises(ValueError, match=message):
        tmrf._check("mrf_stack", *check_args(C, kernel_sizes, dilations))


V1_1024 = {"resblock": "1", "num_mels": 20, "upsample_rates": [8, 8, 2, 2],
           "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 1024,
           "resblock_kernel_sizes": [3, 7, 11],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]]}


def test_hifigan_v1_1024_matches_jax_fused_apply(monkeypatch):
    """HiFi-GAN V1 at `upsample_initial_channel` 1024: the first stage is
    512 wide and runs one `mrf_stack` call per branch (on CUDA: the kernel
    at 512), the next 256 (the same, at 256), then 128 (the whole stage)
    and 64 (folded).  Weights from a seed, carried into flax by the JAX
    package's converter and back into the port by `convert.py`."""
    torch.manual_seed(4)
    params = convert_torch_generator(
        {k: v.numpy() for k, v in thifigan.HiFiGANGenerator.from_config(
            V1_1024, device="cpu").state_dict().items()}, V1_1024)
    port = torch_hifigan_like(V1_1024, params)   # convert.hifigan_state_dict, strict
    mel = np.random.RandomState(4).randn(1, 2, 20).astype(np.float32)
    want = j_fused_apply(params, jnp.asarray(mel), V1_1024, interpret=True)

    calls = []
    real_stack = thifigan.mrf_stack

    def recording(x, st, kernel_sizes, dilations):
        calls.append((x.shape[-1], tuple(kernel_sizes)))
        return real_stack(x, st, kernel_sizes, dilations)

    monkeypatch.setattr(thifigan, "mrf_stack", recording)
    with torch.no_grad():
        got = port(t(mel))
    assert got.shape == want.shape == (1, 2 * 256)
    assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert calls == [(512, (3,)), (512, (7,)), (512, (11,)), (256, (3,)), (256, (7,)),
                     (256, (11,)), (128, V1_KS)]
    assert [thifigan.stage_mode(c, f) for c, f in ((512, 16), (256, 128), (128, 256),
                                                   (64, 512))] == [
        "branchwise", "branchwise", "whole", "folded"]
