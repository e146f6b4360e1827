"""Manual GPU benchmark: the denoiser's forward and forward + backward at
the training shape, the counterpart of tests/bench_denoiser_grad.py.

The unfused 20-layer, 256-channel denoiser (block by block, as training
runs it; the serving kernel is not used) at B=8, T=512 on random x_t
[B, T, 80], t in [0, 4) and conditioning [B, T, 256] (numpy, seed 0), loss
sum(out ** 2): the forward, and the gradients of every parameter.  CUDA
events, best of 3 rounds of 50 after a warm-up, fp32 with TF32 off; FLOPs
counted by `torch.utils.flop_counter.FlopCounterMode`, the TFLOP/s as a
share of the H100 SXM's published peaks (67 TFLOP/s fp32, 989 bf16; at the
card's power limit, printed first).

    python3 tests/bench_torch_denoiser_grad.py [B] [T]
    python3 tests/bench_torch_denoiser_grad.py 1 8 --device cpu --iters 1

It runs on the card unless `--device cpu` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch_step_parts import report  # noqa: E402
from mixgantts_tpu_torch.bench import card_line, full_fp32  # noqa: E402
from mixgantts_tpu_torch.models.denoiser import Denoiser  # noqa: E402
from mixgantts_tpu_torch.utils.tools import resolve_device  # noqa: E402


def main(B=8, T=512, device=None, iters=50):
    """Print the card, the shapes and one line a part; return
    {part: (ms, GFLOP)}."""
    device = resolve_device(device)
    full_fp32()
    torch.manual_seed(0)
    model = Denoiser(n_mels=80, d_encoder=256, residual_channels=256,
                     residual_layers=20).to(device)
    r = np.random.RandomState(0)
    x_t = torch.as_tensor(r.randn(B, T, 80).astype(np.float32), device=device)
    t = torch.as_tensor(r.randint(0, 4, (B,)), device=device)
    cond = torch.as_tensor(r.randn(B, T, 256).astype(np.float32), device=device)
    print(card_line() if device.type == "cuda" else "device cpu: plumbing only, no device metric")
    print(f"device={device} torch {torch.__version__} B={B} T={T}, 20 x 256 unfused",
          flush=True)

    def loss():
        out = model(x_t, t, cond, fused=False)
        return (out * out).sum()

    def fwd():
        with torch.no_grad():
            return loss()

    def grad():
        model.zero_grad(set_to_none=True)
        loss().backward()

    return {"fwd": report("denoiser fwd", fwd, device, iters),
            "fwd+bwd": report("denoiser fwd+bwd", grad, device, iters)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("B", nargs="?", type=int, default=8)
    parser.add_argument("T", nargs="?", type=int, default=512)
    parser.add_argument("--device", default=None, help="default cuda")
    parser.add_argument("--iters", type=int, default=50, help="calls a round")
    args = parser.parse_args()
    main(args.B, args.T, args.device, args.iters)
