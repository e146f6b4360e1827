"""Where a training step on the card parts from the same step on the CPU.

`chip_smoke.py` phase 12 holds one full-width step (B=2, T=128, dropout
off, the same injected noise) on the GPU against the CPU, gradient tensor
by tensor.  This script takes that step (`chip_smoke.step_on_gpu_and_cpu`)
twice on the GPU and once on the CPU, recording the input of every ReLU
(`torch.nn.functional.relu`) the forward passes run, and prints:

- each gradient tensor that phase 12's bar fails, for GPU against CPU and
  for the GPU against itself (a second run: atomics sum in another order);
- the ReLU inputs whose sign differs between the GPU and the CPU, per call
  site, with the largest |input| among them (a kink within rounding of 0
  passes the gradient on one device only).

    python tests/train_step_kinks_torch.py [naive|shallow|aux]

It needs one CUDA device and imports nothing of JAX.
"""

import collections
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def recorded_relu_inputs(torch, fn):
    """fn()'s result and, per call site of F.relu (file:line), the inputs it
    saw, in call order, on the CPU."""
    import torch.nn.functional as F
    seen = collections.defaultdict(list)
    relu = F.relu

    def recording(x, *args, **kwargs):
        frame = traceback.extract_stack(limit=2)[0]
        seen[f"{os.path.relpath(frame.filename, REPO)}:{frame.lineno}"].append(
            x.detach().float().cpu())
        return relu(x, *args, **kwargs)

    F.relu = recording
    try:
        return fn(), seen
    finally:
        F.relu = relu


def failing(label, got, want):
    """Phase 12's per-tensor bar on two (losses, gradients) runs: prints the
    tensors it fails, each with its share of elements past 1e-3 max|g|."""
    (_, gg), (_, cg) = got, want
    for tag in ("G", "D"):
        names = [k for k in cg if k.startswith(tag)]
        top = max(float(cg[k].abs().max()) for k in names)
        for k in names:
            bar = max(float(cg[k].abs().max()), 1e-3 * top)
            diff = (gg[k] - cg[k]).abs()
            frac = float((diff > 1e-3 * bar).float().mean())
            if frac > 1e-2 or float(diff.max()) > 1e-2 * bar:
                print(f"  [{label}] {k}: max|diff| / max|g| {float(diff.max()) / bar:.3e}, "
                      f"{frac:.2%} of {diff.numel()} elements past 1e-3 max|g|", flush=True)


def main(argv):
    import torch
    from mixgantts_tpu_torch.config import get_configs_of
    mode = argv[0] if argv else "naive"
    if not torch.cuda.is_available():
        sys.exit("train_step_kinks_torch: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(smoke.gpu_line(), flush=True)
    pre, cfg, tc = get_configs_of("LJSpeech")
    (gpu, cpu), seen = recorded_relu_inputs(
        torch, lambda: smoke.step_on_gpu_and_cpu(torch, mode, pre, cfg, tc))
    gpu2, _ = smoke.step_on_gpu_and_cpu(torch, mode, pre, cfg, tc)
    failing(f"{mode} GPU vs CPU", gpu, cpu)
    failing(f"{mode} GPU vs GPU", gpu, gpu2)
    for site, xs in sorted(seen.items()):
        half = len(xs) // 2   # the GPU's calls, then the CPU's, in the same order
        flips, n, largest = 0, 0, 0.0
        for a, b in zip(xs[:half], xs[half:]):
            differ = (a > 0) != (b > 0)
            flips += int(differ.sum())
            n += a.numel()
            if differ.any():
                largest = max(largest, float(torch.maximum(a.abs(), b.abs())[differ].max()))
        print(f"  {site}: {half} calls, {n} inputs, {flips} of differing sign "
              f"(largest |input| among them {largest:.3e})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
