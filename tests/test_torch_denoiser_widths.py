"""The denoiser stack at the widths the CUDA kernel is not built for.

The CUDA kernel runs C in {64, 128, 256, 512}; `ops.denoiser_stack` runs any
C <= 512 at the next of them, Cp, and any wider C on its wide route (two
launches a layer) at the next multiple of 64, with zero channels above C
(`kernel_width`, `pad_denoiser_width`, `pad_channels`), and cuts the
outputs back to C.  What the card computes is the plain layers
(`residual_layers_plain`) on those padded tensors: the weights it reads
padded once, the step projections and the speaker term projected at C and
padded per call, as `_launch` pads them (`padded_stack` below).  These
cases hold that, here on the CPU:

- padded and cut back, the layers equal the unpadded stack within
  1e-6 of max|unpadded| (the same fp32 sums plus zero terms, which a
  convolution of another width may add in another order), with and
  without a speaker term, and the channels above C stay exactly zero,
  up to the wide route's 544 and 768;
- each half of the 2C weight axes (gate | filter, residual | skip) and
  each layer's block of the conditioner projection is padded on its own;
- at C = 16 (the tiny test configs' width) the padded stack against JAX's
  `fused_residual_stack` in interpret mode: fp32 at the pinned 2e-5
  (test_pallas.py), bf16 operands at the MRF's bf16 bar
  (test_torch_kernels.py);
- the width rule: the next kernel width up to 512, the next multiple of 64
  above, and `_check` takes every width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgantts_tpu.ops import pallas as jpallas
from mixgantts_tpu_torch.ops import denoiser_stack as tden
from test_torch_kernels import as_torch, assert_bf16_close, denoiser_case


def numpy_stack(L, C, Hc, H, seed, speaker):
    r = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(r.randn(*shape) * scale, dtype=torch.float32)

    st = {"conv_w": t(L, 3, C, 2 * C, scale=(3 * C) ** -0.5), "conv_b": t(L, 2 * C, scale=0.1),
          "cond_w": t(L, Hc, C, scale=Hc ** -0.5), "cond_b": t(L, C, scale=0.1),
          "step_w": t(L, C, C, scale=C ** -0.5),
          "out_w": t(L, C, 2 * C, scale=C ** -0.5), "out_b": t(L, 2 * C, scale=0.1)}
    if speaker:
        st["spk_w"] = t(L, H, C, scale=H ** -0.5)
    return st, t


def padded_stack(x, cond, step, st, Cp, spk=None):
    """The stack as the CUDA kernel's route computes it at width Cp, in
    plain PyTorch: the weights through `pad_denoiser_width`, the step
    projections at C then padded, the conditioner projections by the
    padded weights with the padded speaker term added."""
    padded = tden.pad_denoiser_width(st, Cp)
    pad = tden.pad_channels
    step_proj, condp = tden.hoisted_projections(cond, step, padded,
                                                None if spk is None else pad(spk, Cp))
    return tden.residual_layers_plain(pad(x, Cp), pad(step_proj, Cp), condp, padded)


@pytest.mark.parametrize("speaker", [False, True], ids=["one_speaker", "multi_speaker"])
@pytest.mark.parametrize("C", [16, 48, 80, 200, 288, 512, 544, 768])
def test_padded_stack_equals_unpadded(C, speaker):
    B, T, Hc, H = 2, 70, 24, 12
    L = 2 if tden.is_wide(C) else 3
    st, t = numpy_stack(L, C, Hc, H, seed=C, speaker=speaker)
    x, cond, step = t(B, T, C), t(B, T, Hc), t(B, C)
    spk = tden.speaker_projections(t(B, H), st) if speaker else None
    Cp = tden.kernel_width(C)
    assert Cp == (min(w for w in (64, 128, 256, 512) if w >= C) if C <= 512
                  else -(-C // 64) * 64)
    got = padded_stack(x, cond, step, st, Cp, spk)
    want = tden.fused_residual_stack_plain(x, cond, step, st, spk)
    for g, w in zip(got, want):
        assert g.shape == (B, T, Cp)
        assert torch.count_nonzero(g[..., C:]) == 0   # the zero channels stay zero
        err = (g[..., :C] - w).abs().max().item()
        assert err <= 1e-6 * w.abs().max().item(), err
    if speaker:   # the speaker term moved the result, so it was compared
        assert (want[1] - tden.fused_residual_stack_plain(x, cond, step, st)[1]).abs().max() > 1e-2


def test_pad_denoiser_width_pads_each_half():
    L, C, Cp, Hc, H = 2, 16, 64, 8, 4
    st, _ = numpy_stack(L, C, Hc, H, seed=1, speaker=True)
    p = tden.pad_denoiser_width(st, Cp)
    for key, rows in (("conv_w", True), ("out_w", True), ("conv_b", False), ("out_b", False)):
        w, pw = st[key], p[key]
        if rows:   # the input channels: C real, then zeros
            assert torch.count_nonzero(pw[..., C:Cp, :]) == 0
            pw = pw[..., :C, :]
        assert pw.shape[-1] == 2 * Cp
        assert torch.equal(pw[..., :C], w[..., :C])              # gate, or residual
        assert torch.equal(pw[..., Cp:Cp + C], w[..., C:])       # filter, or skip
        assert torch.count_nonzero(pw[..., C:Cp]) == torch.count_nonzero(pw[..., Cp + C:]) == 0
    # the step and speaker weights stay at C: their projections are padded per call
    assert p["step_w"] is st["step_w"] and p["spk_w"] is st["spk_w"]
    kw = tden.denoiser_kernel_weights(st)
    # the conditioner projection side by side, each layer's block padded on its own
    blocks = kw["cond_w_cat"].reshape(Hc, L, Cp)
    assert torch.equal(blocks[..., :C], st["cond_w"].permute(1, 0, 2))
    assert torch.count_nonzero(blocks[..., C:]) == 0
    assert torch.equal(kw["cond_b_cat"].reshape(L, Cp)[:, :C], st["cond_b"])
    assert kw["conv_w_mma"].shape == (L, Cp // tden.GROUP, 3 * Cp * 2 * tden.GROUP)
    assert kw["conv_b_mma"].shape == kw["out_b_mma"].shape == (L, 2 * Cp)
    assert kw["conv_w"].shape == (L, 3, C, 2 * C)   # the plain version's stack stays at C


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_padded_stack_matches_pallas_at_c16(dtype):
    B, T, L, C, Hc = 2, 70, 3, 16, 24
    x, cond, step, stacked = denoiser_case(B, T, L, C, Hc, seed=16)
    args = [torch.tensor(np.asarray(a)) for a in (x, cond, step)]
    st = as_torch(stacked)
    if dtype == "bf16":
        st = tden.denoiser_kernel_weights(st)
        stacked = dict(stacked, conv_w=stacked["conv_w"].astype(jnp.bfloat16),
                       out_w=stacked["out_w"].astype(jnp.bfloat16))
    want = jpallas.fused_residual_stack(x, cond, step, stacked, tile=32, interpret=True)
    got = padded_stack(*args, st, tden.kernel_width(C))
    for g, w in zip(got, want):
        if dtype == "bf16":
            assert_bf16_close(g[..., :C], w)
        else:
            np.testing.assert_allclose(g[..., :C].numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_kernel_width_names_its_limit():
    """Up to 512 the next of the kernel's widths; above, the wide route at
    the next multiple of 64, at any width: nothing raises for width."""
    assert [tden.kernel_width(c) for c in (1, 16, 64, 65, 128, 129, 256, 257, 512)] == [
        64, 64, 64, 128, 128, 256, 256, 512, 512]
    assert [tden.kernel_width(c) for c in (513, 544, 1000, 2048)] == [576, 576, 1024, 2048]
    assert [tden.is_wide(c) for c in (512, 513, 2048)] == [False, True, True]
    for C in (544, 1000, 2048):
        x = torch.zeros(1, 8, C, device="meta")
        st = {"conv_w": torch.zeros(1, 3, C, 2 * C, device="meta"),
              "conv_b": torch.zeros(1, 2 * C, device="meta"),
              "out_w": torch.zeros(1, C, 2 * C, device="meta"),
              "out_b": torch.zeros(1, 2 * C, device="meta")}
        tden._check(x, torch.zeros(1, 8, 4, device="meta"), torch.zeros(1, C, device="meta"),
                    st)
