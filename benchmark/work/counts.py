"""The work the rooflines and the MFU divide by: operations and bytes
from shapes, and the peaks of one H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit).  `denoiser_work` and `mrf_work` are the formulas the
port's `chip_smoke.py` bounds its kernels with."""

PEAK_FP32 = 67e12      # FLOP/s, float32 outside the tensor cores
PEAK_BF16 = 989e12     # FLOP/s, bf16 on the tensor cores
PEAK_BYTES = 3.35e12   # B/s, HBM3


def least_s(flops, nbytes, peak):
    """The least time a kernel of `flops` and `nbytes` takes at `peak`."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def denoiser_work(B, T, C, Hc, L, weight_bytes=4, hoisted=True):
    """FLOP and bytes of the denoiser's residual stack: inputs read once,
    outputs written once; conv_w and out_w at `weight_bytes` each, the
    other weights and the activations fp32.  With `hoisted` (the whole
    `fused_residual_stack` call) the conditioner and step projections
    count, with cond read; without (the kernel alone) they do not, and
    the kernel reads their results, the projections [L, B, T, C] and
    [L, B, C]."""
    flops = L * (2 * B * T * 3 * C * 2 * C      # k = 3 conv, C -> 2C
                 + 2 * B * T * C * 2 * C)       # output projection
    mma_weights = L * (3 * C * 2 * C + C * 2 * C)
    biases = L * (2 * C + 2 * C)
    if hoisted:
        flops += L * (2 * B * T * Hc * C + 2 * B * C * C)
        weights = biases + L * (Hc * C + C + C * C)
        inputs = B * T * C + B * T * Hc + B * C
    else:
        weights = biases
        inputs = B * T * C + L * B * T * C + L * B * C
    nbytes = 4 * (inputs + weights + 2 * B * T * C) + weight_bytes * mma_weights
    return flops, nbytes


def mrf_work(B, T, C, kernel_sizes, n_pair=3, weight_bytes=4):
    """FLOP and bytes of one MRF stage: per branch and pair two k-tap
    convs; the signal read once and written once in fp32, the weights read
    once."""
    flops = sum(n_pair * 2 * (2 * k * C * C * B * T) for k in kernel_sizes)
    weights = sum(n_pair * 2 * (weight_bytes * k * C * C + 4 * C) for k in kernel_sizes)
    return flops, 4 * 2 * B * T * C + weights


def mrf_stages(hifigan, B, frames):
    """(B, T, C) of each MRF stage of a HiFi-GAN config over `frames` mel
    frames."""
    out, T = [], frames
    for i, u in enumerate(hifigan["upsample_rates"]):
        T *= u
        out.append((B, T, hifigan["upsample_initial_channel"] // 2 ** (i + 1)))
    return out


def kernel_parts(config, B, T):
    """{"denoiser": (flops, bytes), "mrf": [(flops, bytes) a stage]} of one
    synthesis call: the work of the hand-written kernels, with bf16
    weights (their operand type)."""
    d = config["model"]["denoiser"]
    H = config["model"]["transformer"]["encoder_hidden"]
    steps = d["shallow_timesteps"]
    df, db = denoiser_work(B, T, d["residual_channels"], H, d["residual_layers"], 2,
                           hoisted=False)
    voc = config["hifigan"]
    n_pair = len(voc["resblock_dilation_sizes"][0])
    mrf = [mrf_work(b, t, c, voc["resblock_kernel_sizes"], n_pair, 2)
           for b, t, c in mrf_stages(voc, B, T)]
    return {"denoiser": (steps * df, steps * db), "mrf": mrf}


def counted_flops(fn):
    """The FLOP that `torch.utils.flop_counter` counts in fn() (matrix
    products and convolutions, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def synth_flops(config, B, P, W, T):
    """(fp32 FLOP, bf16 FLOP) of one synthesis call of B sentences at P
    phone slots, W word slots and T frames, counted on the reference on the
    meta device; the bf16 part is the kernels' (`kernel_parts`)."""
    import torch
    from ..core import ref_config
    from ..reference.acoustic import Generator
    from ..reference.hifigan import HiFiGAN

    with torch.device("meta"):
        G = Generator(ref_config(config), config["stats"]).to("meta").eval()
        V = HiFiGAN(config["hifigan"]).to("meta")
        texts = torch.ones(B, P, dtype=torch.long)
        lens = torch.full((B,), P, dtype=torch.long)
        wb = torch.ones(B, W, dtype=torch.long)
        w_lens = torch.full((B,), W, dtype=torch.long)
        noise = torch.zeros(B, T, G.n_mels)
        steps = torch.zeros(G.diffusion.num_timesteps, B, T, G.n_mels)

    def call():
        with torch.no_grad():
            out = G.synthesize(texts, lens, wb, w_lens, T, noise, steps)
            V(out.mel)

    total = counted_flops(call)
    parts = kernel_parts(config, B, T)
    bf16 = parts["denoiser"][0] + sum(f for f, _ in parts["mrf"])
    return total - bf16, bf16


def least_call_s(fp32_flops, bf16_flops):
    """The least time of work counted at the peak of its stated type."""
    return fp32_flops / PEAK_FP32 + bf16_flops / PEAK_BF16

