"""The work counts the rooflines and the MFU divide by, pinned at the
cells' shapes (CPU)."""

import pytest
import torch

from benchmark.core import load_json, HERE
from benchmark.reference.arith import FULL
from benchmark.reference.acoustic import ResidualBlock
from benchmark.reference.hifigan import ResBlock1
from benchmark.work import counts

V1 = load_json(HERE, "configs", "ljspeech_shallow_v1.json")
V2 = load_json(HERE, "configs", "ljspeech_shallow_v2.json")


def test_mrf_work_of_hifigan_v1_at_b1_t1000():
    flops = sum(counts.mrf_work(b, t, c, (3, 7, 11))[0]
                for b, t, c in counts.mrf_stages(V1["hifigan"], 1, 1000))
    assert flops == 594_542_592_000        # ~595 GFLOP a B=1 request


def test_mrf_work_of_hifigan_v2():
    flops = sum(f for f, _ in counts.kernel_parts(V2, 1, 1000)["mrf"])
    assert flops == 37_158_912_000         # ~37.2 GFLOP a B=1 request


def test_mrf_stages_of_v1():
    assert counts.mrf_stages(V1["hifigan"], 16, 1000) == [
        (16, 8000, 256), (16, 64000, 128), (16, 128000, 64), (16, 256000, 32)]


def test_denoiser_work_as_chip_smoke_counts_it():
    flops, nbytes = counts.denoiser_work(1, 1000, 256, 256, 20)
    assert flops == 20 * (2 * 1000 * 3 * 256 * 512 + 2 * 1000 * 256 * 512
                          + 2 * 1000 * 256 * 256 + 2 * 256 * 256)
    # the kernel alone: no hoisted projections, their results read instead
    kf, kb = counts.denoiser_work(16, 1000, 256, 256, 20, weight_bytes=2, hoisted=False)
    assert kf == 20 * (2 * 16000 * 3 * 256 * 512 + 2 * 16000 * 256 * 512)
    assert kb == 4 * (16000 * 256 + 20 * 16000 * 256 + 20 * 16 * 256 + 20 * 4 * 256
                      + 2 * 16000 * 256) + 2 * 20 * (3 * 256 * 512 + 256 * 512)


@pytest.mark.parametrize("config, fp32, bf16", [
    (V1, 2_402_811_641_856, 19_696_451_584_000),
    (V2, 1_820_065_529_856, 1_860_173_824_000)])
def test_synth_flops_at_the_cells_shape(config, fp32, bf16):
    assert counts.synth_flops(config, 32, 192, 64, 1000) == (fp32, bf16)


def test_kernel_parts_equal_the_reference_emulation_count():
    """The bf16 part: what FlopCounterMode counts inside the reference's
    kernel arithmetic equals `denoiser_work` and `mrf_work`."""
    B, T, C, Hc = 2, 40, 16, 8
    block = ResidualBlock(Hc, C)
    x, condp, step = torch.zeros(B, T, C), torch.zeros(B, T, C), torch.zeros(B, C)
    got = counts.counted_flops(lambda: block.kernel_forward(x, condp, step, FULL))
    assert got == counts.denoiser_work(B, T, C, Hc, 1, hoisted=False)[0]
    blocks = [ResBlock1(C, k, (1, 3, 5)) for k in (3, 7, 11)]
    xs = torch.zeros(B, C, T)
    got = counts.counted_flops(lambda: [b(xs, FULL) for b in blocks])
    assert got == counts.mrf_work(B, T, C, (3, 7, 11))[0]


def test_least_time_takes_the_larger_bound():
    assert counts.least_s(989e12, 0, counts.PEAK_BF16) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12, counts.PEAK_BF16) == pytest.approx(1.0)
    assert counts.least_call_s(67e12, 989e12) == pytest.approx(2.0)
