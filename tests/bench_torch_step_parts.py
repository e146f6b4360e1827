"""Manual GPU benchmark: the parts of the naive GAN step beside the
denoiser, the counterpart of tests/bench_step_parts.py.

At B=8, T=512, P=128, W=48, on the batch tests/bench_step_parts.py draws
(the same numpy draws, in its order), the flagship naive generator
(random weights from a seed; dropout on, the PostNet's batch statistics)
and the JCU discriminator of the LJSpeech configs:
- the generator's training forward (sum of squares of mel_pred, pitch_pred
  and log_dur_w_pred) and its forward + backward (gradients of every
  parameter);
- the discriminator's forward on (x, x) at t = 0 (sum of squares of both
  branches' logits) and its forward + backward (gradients of its
  parameters and both inputs).
Each timed with CUDA events, best of 3 rounds of 50 after a warm-up, fp32
with TF32 off; FLOPs counted by `torch.utils.flop_counter.FlopCounterMode`
over one call, and the TFLOP/s that follow, as a share of the H100 SXM's
published peaks (67 TFLOP/s fp32, 989 bf16; at the card's power limit,
printed first).

    python3 tests/bench_torch_step_parts.py [B] [T]
    python3 tests/bench_torch_step_parts.py 2 16 --device cpu --tiny --iters 1

It runs on the card unless `--device cpu` is given.  `--tiny` takes the
tiny flagship model and a 16-slot, 5-word text (its 16 positions), with
T <= 16.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from mixgantts_tpu_torch.bench import best_ms, card_line, full_fp32  # noqa: E402
from mixgantts_tpu_torch.cli.common import build_discriminator  # noqa: E402
from mixgantts_tpu_torch.flagship import TINY_REQUEST, flagship_model  # noqa: E402
from mixgantts_tpu_torch.train.step import model_kwargs  # noqa: E402
from mixgantts_tpu_torch.utils.tools import resolve_device  # noqa: E402

PEAK_FP32, PEAK_BF16 = 67e12, 989e12   # H100 SXM, dense, at 700 W


def step_batch(r, B, T, P, W, n_mels):
    """tests/bench_step_parts.py's batch, drawn from `r` in its order."""
    wb = r.randint(1, 4, (B, W)).astype(np.int64)
    src_lens = wb.sum(-1)
    texts = np.zeros((B, P), np.int64)
    for b in range(B):
        texts[b, :src_lens[b]] = r.randint(1, 300, src_lens[b])
    d_targets = np.zeros((B, P), np.int64)
    for b in range(B):
        d_targets[b, :src_lens[b]] = r.randint(2, 8, src_lens[b])
    mel_lens = np.minimum(d_targets.sum(-1), T)
    return dict(
        speakers=np.zeros((B,), np.int64), texts=texts, src_lens=src_lens,
        word_boundaries=wb, src_w_lens=np.full((B,), W, np.int64),
        mels=r.randn(B, T, n_mels).astype(np.float32), mel_lens=mel_lens,
        attn_priors=np.ones((B, P, T), np.float32) / P,
        p_targets=r.randn(B, P).astype(np.float32),
        e_targets=r.randn(B, P).astype(np.float32),
        d_targets=d_targets)


def report(name, fn, device, iters):
    """Time fn and count its FLOPs; print one line; return (ms, GFLOP)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    flops = counter.get_total_flops()
    ms = best_ms(fn, device, iters)
    tflops = flops / ms / 1e9
    shares = (f" ({100 * tflops * 1e12 / PEAK_FP32:.1f}% of the fp32 peak, "
              f"{100 * tflops * 1e12 / PEAK_BF16:.2f}% of bf16)" if device.type == "cuda" else "")
    print(f"{name:24s}: {ms:9.3f} ms  {flops / 1e9:8.2f} GFLOP -> {tflops:6.2f} TFLOP/s{shares}",
          flush=True)
    return ms, flops / 1e9


def main(B=8, T=512, device=None, tiny=False, iters=50):
    """Print the card, the shapes and one line a part; return
    {part: (ms, GFLOP)}."""
    device = resolve_device(device)
    full_fp32()
    P, W = TINY_REQUEST if tiny else (128, 48)
    torch.manual_seed(0)
    model, (pre, cfg, _) = flagship_model("naive", tiny=tiny, device=device)
    n_mels = pre["preprocessing"]["mel"]["n_mel_channels"]
    r = np.random.RandomState(0)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in step_batch(r, B, T, P, W, n_mels).items()}
    print(card_line() if device.type == "cuda" else "device cpu: plumbing only, no device metric")
    print(f"device={device} torch {torch.__version__} B={B} T={T} P={P} W={W}; peaks 67 "
          f"TFLOP/s fp32, 989 bf16 (H100 SXM at 700 W)", flush=True)
    model.train()

    def g_loss():
        out = model(**model_kwargs(batch))
        return sum((x * x).sum() for x in (out.mel_pred, out.pitch_pred, out.log_dur_w_pred))

    def g_fwd():
        with torch.no_grad():
            return g_loss()

    def g_grad():
        model.zero_grad(set_to_none=True)
        g_loss().backward()

    out = {"generator fwd": report("generator fwd", g_fwd, device, iters),
           "generator fwd+bwd": report("generator fwd+bwd", g_grad, device, iters)}

    disc = build_discriminator(pre, cfg, device=device)
    x = torch.as_tensor(r.randn(B, T, n_mels).astype(np.float32), device=device)
    xa, xb = (x.clone().requires_grad_() for _ in range(2))
    t = torch.zeros(B, dtype=torch.long, device=device)

    def d_loss():
        cond, uncond = disc(xa, xb, None, t)
        return (cond[-1] ** 2).sum() + (uncond[-1] ** 2).sum()

    def d_fwd():
        with torch.no_grad():
            return d_loss()

    def d_grad():
        disc.zero_grad(set_to_none=True)
        xa.grad = xb.grad = None
        d_loss().backward()

    out["discriminator fwd"] = report("discriminator fwd", d_fwd, device, iters)
    out["discriminator fwd+bwd"] = report("discriminator fwd+bwd", d_grad, device, iters)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("B", nargs="?", type=int, default=8)
    parser.add_argument("T", nargs="?", type=int, default=512)
    parser.add_argument("--device", default=None, help="default cuda")
    parser.add_argument("--tiny", action="store_true", help="the tiny flagship model")
    parser.add_argument("--iters", type=int, default=50, help="calls a round")
    args = parser.parse_args()
    main(args.B, args.T, args.device, args.tiny, args.iters)
