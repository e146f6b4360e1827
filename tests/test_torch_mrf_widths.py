"""The MRF stage at the widths the CUDA kernel is not built for.

The kernels run C in {8, 16, 32, 64} (`csrc/mrf_stage_narrow.cu`) and
{128, 256, 512} (`csrc/mrf_stack.cu`); `ops.mrf` runs any C <= 512 at the
next of them, Cp, with zero channels above C
(`kernel_width`, `pad_mrf_width`, `pad_channels`), and cuts the output back
to C.  What the card computes is the plain stage (`mrf_stack_plain`) on
those padded tensors: the weights padded once in `kernel_weights` (the
keys the kernel reads), x padded per call (`padded_stage` below).  These
cases hold that, here on the CPU:

- padded and cut back, the stage equals the unpadded one within 1e-6 of
  max|unpadded| (zero terms added to the same sums), in fp32 and in the
  kernel's bf16 arithmetic, and the channels above C stay exactly zero;
- `kernel_weights` pads the kernel's tensors once, in the kernel's order,
  and leaves the plain version's at C;
- at C = 16 and 8 (HiFi-GAN V2's last stages, which the narrow kernel runs
  at their own width) the folded stage against JAX's `mrf_stack_folded` in
  interpret mode (rtol 1e-4, atol 1e-5, test_pallas.py's MRF tolerance);
- HiFi-GAN V2's stages (64, 32, 16, 8) and the dryrun's (8, 4) take the
  folded route at the frame buckets of a request: the pair kernel at 64
  and 32 (9 launches a stage), the whole-stage kernel at 16 and 8 (one);
- a small V2-shaped HiFi-GAN through `fused_apply`, with each stage's MRF
  as the card's padded route computes it, against the JAX `fused_apply`
  on the same weights (bridged by the JAX package's own
  `convert_torch_generator`; the same tolerance);
- the kernels' weight layout unpacks back to the padded stacked weights at
  C = 4, 8, 16, 24 and 64 and every odd k (K padded to 16 at 8 channels),
  and the route rule gives each width its kernel and launches a stage;
- above 512 the kernel's width raises, naming the limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.models.hifigan import convert_torch_generator
from mixgantts_tpu.models.hifigan import fused_apply as j_fused_apply
from mixgantts_tpu.ops import pallas_vocoder as jvoc
from mixgantts_tpu_torch.dryrun import TINY_VOCODER
from mixgantts_tpu_torch.models import hifigan as thifigan
from mixgantts_tpu_torch.ops import mrf as tmrf
from test_torch_gpu_kernels import V2_CONFIG, mrf_weights
from torch_port_helpers import assert_close, t


def padded_stage(x, st, kernel_sizes, dilations=(1, 3, 5)):
    """The stage as the CUDA kernel's route computes it, in plain PyTorch:
    x [B, T, C] with zero channels up to `kernel_width(C)`, the weights
    through `pad_mrf_width`, the output cut back to C."""
    C = x.shape[-1]
    Cp = tmrf.kernel_width(C)
    out = tmrf.mrf_stack_plain(tmrf.pad_channels(x, Cp), tmrf.pad_mrf_width(st, Cp),
                               kernel_sizes, dilations)
    assert out.shape[-1] == Cp and torch.count_nonzero(out[..., C:]) == 0
    return out[..., :C]


def unpack_taps(packed, kernel_sizes, Cp):
    """`w1_mma`/`w2_mma` [n_br, n_pair, 11 Cp Cp] back to dense [n_br,
    n_pair, 11, Cp, Cp] (the inverse of `ops.mrf._pack_taps`)."""
    n_br, n_pair, _ = packed.shape
    dense = torch.zeros(n_br, n_pair, tmrf.TAPS, Cp, Cp, dtype=packed.dtype)
    for br, k in enumerate(kernel_sizes):
        pad = (tmrf.TAPS - k) // 2
        kk, n = np.meshgrid(np.arange(k * Cp), np.arange(Cp), indexing="ij")
        at = (((kk // 16) * (Cp // 8) + n // 8) * 2 + (kk % 16) // 8) * 64 + (n % 8) * 8 + kk % 8
        dense[br, :, pad:pad + k] = packed[br][:, torch.as_tensor(at)].reshape(n_pair, k, Cp, Cp)
    return dense


def widths_case(C):
    """The kernel sizes of one call at width C, as `fused_apply` makes it:
    the whole stage up to 128, one branch a call above."""
    return (3, 7, 11) if C <= 128 else (11,)


@pytest.mark.parametrize("arithmetic", ["fp32", "bf16"])
@pytest.mark.parametrize("C", [4, 8, 16, 24, 48, 72, 144, 200])
def test_padded_stage_equals_unpadded(C, arithmetic):
    ks = widths_case(C)
    st = mrf_weights(C, ks, seed=C, device="cpu")
    if arithmetic == "bf16":
        st = tmrf.kernel_weights(st, ks)
    x = torch.tensor(np.random.RandomState(C + 1).randn(2, 90, C), dtype=torch.float32)
    got = padded_stage(x, st, ks)
    want = tmrf.mrf_stack_plain(x, st, ks)
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err


@pytest.mark.parametrize("C", [16, 200])
def test_kernel_weights_pad_once_in_the_kernels_order(C):
    ks = widths_case(C)
    Cp = tmrf.kernel_width(C)
    kw = tmrf.kernel_weights(mrf_weights(C, ks, seed=C, device="cpu"), ks)
    padded = tmrf.pad_mrf_width(kw, Cp)
    for key in ("w1", "w2"):
        assert kw[key].shape == (len(ks), 3, tmrf.TAPS, C, C)   # the plain version's, at C
        assert kw[key + "_mma"].shape == (len(ks), 3, tmrf.TAPS * Cp * Cp)
        assert torch.equal(unpack_taps(kw[key + "_mma"], ks, Cp), padded[key])
    for key in ("b1", "b2"):
        assert kw[key].shape == (len(ks), 3, C)
        assert kw[key + "_mma"].dtype == torch.float32
        assert torch.equal(kw[key + "_mma"][..., :C], kw[key])
        assert torch.count_nonzero(kw[key + "_mma"][..., C:]) == 0


def flax_stage_params(st, kernel_sizes):
    """Stacked weights -> the flax parameters of stage 0 (`resblocks_0_{j}`,
    `convs1_{c}` / `convs2_{c}` kernels [k, in, out]), which the JAX
    package's stacking functions read."""
    params = {}
    for j, k in enumerate(kernel_sizes):
        pad = (tmrf.TAPS - k) // 2
        params[f"resblocks_0_{j}"] = {
            f"convs{i}_{c}": {"kernel": jnp.asarray(st[f"w{i}"][j, c, pad:pad + k].numpy()),
                              "bias": jnp.asarray(st[f"b{i}"][j, c].numpy())}
            for i in (1, 2) for c in range(st["w1"].shape[1])}
    return params


@pytest.mark.parametrize("C", [16, 8])
def test_padded_folded_stage_matches_pallas(C):
    fold, T, B, rks = 128 // C, 256, 2, (3, 7, 11)
    st = mrf_weights(C, rks, seed=C, device="cpu")
    x = np.random.RandomState(C).randn(B, T, C).astype(np.float32)
    xf = jnp.asarray(x.reshape(B, T // fold, fold * C))   # contiguous == folded layout
    want = jvoc.mrf_stack_folded(
        xf, jvoc.stack_mrf_params_folded(flax_stage_params(st, rks), 0, fold),
        interpret=True, prefolded=True)
    got = padded_stage(torch.as_tensor(x), st, rks)
    assert tmrf.kernel_width(C) == C and tmrf.route(C) == "mrf_stage_narrow"
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, T, C), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("config,T_mel,widths", [
    (V2_CONFIG, 1000, (64, 32, 16, 8)),   # a B=1 request at frame bucket 1000
    (V2_CONFIG, 512, (64, 32, 16, 8)),    # B=4 at 512
    (TINY_VOCODER, 16, (8, 4)),           # the dryrun's synthesis
])
def test_narrow_stages_take_the_folded_route(config, T_mel, widths):
    """Every stage of V2 and of the dryrun's vocoder is time-folded, as in
    the JAX `fused_apply` (F = 128 / C divides the frames): the pair kernel
    at 64 and 32 (9 launches a stage), the whole-stage kernel at its own
    width below 32 (8 for C = 4, one launch): 20 launches a V2 request."""
    C, T, modes = config["upsample_initial_channel"], T_mel, []
    for u in config["upsample_rates"]:
        C, T = C // 2, T * u
        modes.append((C, thifigan.stage_mode(C, T), tmrf.route(C), tmrf.kernel_width(C)))
        assert T % (128 // C) == 0
    assert modes == [(c, "folded", "mrf_stage_narrow" if c <= 16 else "mrf_pair_mma",
                      max(c, 8)) for c in widths]
    launches = sum(tmrf.stage_launches(c, len(config["resblock_kernel_sizes"]),
                                       len(config["resblock_dilation_sizes"][0]))
                   for c in widths)
    assert launches == (20 if config is V2_CONFIG else 2)


def test_v2_shaped_hifigan_matches_jax_fused_apply(monkeypatch):
    """A small V2-shaped HiFi-GAN (rates 8, 8, 2, 2; stages 16, 8, 4, 2,
    every one folded) through the port's `fused_apply`, on the CPU and with
    each stage's MRF as the card's padded route computes it, against the
    JAX `fused_apply` (Pallas in interpret mode) on the same weights."""
    config = dict(V2_CONFIG, num_mels=20, upsample_initial_channel=32)
    torch.manual_seed(2)
    port = thifigan.HiFiGANGenerator.from_config(config, device="cpu")
    params = convert_torch_generator({k: v.numpy() for k, v in port.state_dict().items()},
                                     config)
    mel = np.random.RandomState(2).randn(1, 4, 20).astype(np.float32)
    want = j_fused_apply(params, jnp.asarray(mel), config, interpret=True)
    with torch.no_grad():
        got = port(t(mel))
    assert_close(got, want, rtol=1e-4, atol=1e-5)

    widths = []

    def folded_as_the_card_runs_it(x, st, kernel_sizes, dilations, prefolded):
        B, R, Cf = x.shape
        x = x.reshape(B, R * st["fold"], Cf // st["fold"])
        widths.append(x.shape[-1])
        return padded_stage(x, st, kernel_sizes, dilations)

    monkeypatch.setattr(thifigan, "mrf_stack_folded", folded_as_the_card_runs_it)
    port._stacked = None
    with torch.no_grad():
        got = port(t(mel))
    assert widths == [16, 8, 4, 2]
    assert_close(got, want, rtol=1e-4, atol=1e-5)


def unpack_padded_taps(packed, kernel_sizes, Cp):
    """`w1_mma`/`w2_mma` [n_br, n_pair, packed_taps(Cp)] back to dense [n_br,
    n_pair, 11, Cp, Cp], and the K rows past k Cp (zero padding to a
    multiple of 16, at Cp = 8 and odd k) as [n_br, n_pair, pad, Cp]."""
    n_br, n_pair, _ = packed.shape
    dense = torch.zeros(n_br, n_pair, tmrf.TAPS, Cp, Cp, dtype=packed.dtype)
    pads = []
    for br, k in enumerate(kernel_sizes):
        K = -(-k * Cp // 16) * 16
        kk, n = np.meshgrid(np.arange(K), np.arange(Cp), indexing="ij")
        at = torch.as_tensor((((kk // 16) * (Cp // 8) + n // 8) * 2 + (kk % 16) // 8) * 64
                             + (n % 8) * 8 + kk % 8)
        rows = packed[br][:, at]                                  # [n_pair, K, Cp]
        pad = (tmrf.TAPS - k) // 2
        dense[br, :, pad:pad + k] = rows[:, :k * Cp].reshape(n_pair, k, Cp, Cp)
        pads.append(rows[:, k * Cp:])
    return dense, pads


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11])
@pytest.mark.parametrize("C", [4, 8, 16, 24, 64])
def test_kernel_weights_unpack_at_every_narrow_width_and_k(C, k):
    """The kernels' weight layout, made once in `kernel_weights` at the
    stage's kernel width (8, 16, 32 or 64 here), unpacks back to the stacked
    weights padded to that width; at Cp = 8 an odd k's K rows are padded to
    a multiple of 16 with zeros, and every (branch, pair) holds
    `packed_taps(Cp)` elements."""
    ks = (k, 3) if k != 3 else (k,)
    Cp = tmrf.kernel_width(C)
    kw = tmrf.kernel_weights(mrf_weights(C, ks, seed=C + k, device="cpu"), ks)
    padded = tmrf.pad_mrf_width(kw, Cp)
    for key in ("w1", "w2"):
        assert kw[key + "_mma"].shape == (len(ks), 3, tmrf.packed_taps(Cp))
        dense, pads = unpack_padded_taps(kw[key + "_mma"], ks, Cp)
        assert torch.equal(dense, padded[key])
        assert all(torch.count_nonzero(p) == 0 for p in pads)
        assert [p.shape[1] for p in pads] == [-(-kk * Cp // 16) * 16 - kk * Cp for kk in ks]


@pytest.mark.parametrize("C,route,width,launches", [
    (1, "mrf_stage_narrow", 8, 1), (4, "mrf_stage_narrow", 8, 1), (8, "mrf_stage_narrow", 8, 1),
    (9, "mrf_stage_narrow", 16, 1), (16, "mrf_stage_narrow", 16, 1),
    (17, "mrf_pair_mma", 32, 9), (24, "mrf_pair_mma", 32, 9), (32, "mrf_pair_mma", 32, 9),
    (48, "mrf_pair_mma", 64, 9), (64, "mrf_pair_mma", 64, 9), (72, "mrf_pair_mma", 128, 9),
    (256, "mrf_pair_mma", 256, 9), (257, "mrf_wide_mma", 512, 18), (512, "mrf_wide_mma", 512, 18),
])
def test_route_by_width(C, route, width, launches):
    """Which CUDA kernel a stage of C channels reaches from `mrf_stack` and
    `mrf_stack_folded`, at which width, and its launches for V1's three
    branches of three pairs: the whole stage once at C <= 16, one launch
    per branch and pair above, two at 512; and the mode `fused_apply` calls
    it in at a request's frames (time-folded for C <= 64 where F = 128 / C
    divides them)."""
    assert (tmrf.route(C), tmrf.kernel_width(C), tmrf.stage_launches(C, 3, 3)) == (
        route, width, launches)
    T = 8 * 128
    want = ("folded" if C <= 64 and 128 % C == 0 else "whole" if C <= 128 else "branchwise")
    assert thifigan.stage_mode(C, T) == want


def test_kernel_width_names_its_limit():
    assert [tmrf.kernel_width(c) for c in (1, 8, 32, 33, 64, 65, 129, 256, 257, 512)] == [
        8, 8, 32, 64, 64, 128, 256, 256, 512, 512]
    with pytest.raises(ValueError, match="C <= 512"):
        tmrf.kernel_width(513)
    st = mrf_weights(8, (3,), device="cpu")
    assert set(tmrf.kernel_weights(st, (3,))) >= {"w1_mma", "w2_mma", "b1_mma", "b2_mma"}
    wide = {k: torch.zeros(*v.shape[:-2], 544, 544) if v.dim() == 5 else torch.zeros(1, 3, 544)
            for k, v in st.items()}
    assert "w1_mma" not in tmrf.kernel_weights(wide, (3,))   # nothing to pad it to
