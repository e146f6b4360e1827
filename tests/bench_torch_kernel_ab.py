"""Manual GPU benchmark: the serving route's kernel times of the port found
under ROOT, for comparing two trees in one call on one card.

Times (CUDA events, TF32 off, random weights and inputs from seed 0) the
denoiser stack at C = 256 (B=1, T=1000, 20 layers), V1's C = 256 MRF stage
through three one-branch `mrf_stack` calls (B=1, T=8000), the whole V1
stage through `mrf_stack_streamed` at C = 256 and 512 (B=1, T=8000), and
the narrow stages through `mrf_stack_folded` as `fused_apply` calls them
(B=1, bucket 1000): V1's C = 64 and 32 (T = 128,000 and 256,000) and
HiFi-GAN V2's four (C = 64, 32, 16, 8 at T = 8,000, 64,000, 128,000 and
256,000), each stage's launches beside it, and the sum of each request's;
and prints the card line, then one JSON line labelled LABEL.  Run it on two
trees in turns (parent, change, change, parent), each tree's kernels built
in its own `mixgantts_tpu_torch/_build/`:

    python3 tests/bench_torch_kernel_ab.py /path/to/parent parent
    python3 tests/bench_torch_kernel_ab.py . change
"""

import json
import os
import subprocess
import sys

root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402

from mixgantts_tpu_torch.ops import denoiser_stack as den  # noqa: E402
from mixgantts_tpu_torch.ops import mrf  # noqa: E402

if not den.__file__.startswith(root):
    raise SystemExit(f"imported {den.__file__}, not the tree under {root}")
if not torch.cuda.is_available():
    raise SystemExit("bench_torch_kernel_ab: no CUDA device")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator("cuda").manual_seed(0)


# the stages `fused_apply` folds in one B=1 request at bucket 1000, (C, T)
NARROW_STAGES = {"v1_folded": ((64, 128000), (32, 256000)),
                 "v2": ((64, 8000), (32, 64000), (16, 128000), (8, 256000))}


def time_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=g) * scale


def mrf_weights(C, kernel_sizes, n_pair=3):
    w1 = torch.zeros(len(kernel_sizes), n_pair, mrf.TAPS, C, C, device="cuda")
    w2 = torch.zeros_like(w1)
    for br, k in enumerate(kernel_sizes):
        pad = (mrf.TAPS - k) // 2
        w1[br, :, pad:pad + k] = rnd(n_pair, k, C, C, scale=(k * C) ** -0.5)
        w2[br, :, pad:pad + k] = rnd(n_pair, k, C, C, scale=(k * C) ** -0.5)
    n_br = len(kernel_sizes)
    return {"w1": w1, "w2": w2, "b1": rnd(n_br, n_pair, C, scale=0.1),
            "b2": rnd(n_br, n_pair, C, scale=0.1)}


def main():
    out = {"label": label}
    with torch.no_grad():
        C, L, Hc = 256, 20, 256
        st = {"conv_w": rnd(L, 3, C, 2 * C, scale=(3 * C) ** -0.5),
              "conv_b": rnd(L, 2 * C, scale=0.1), "cond_w": rnd(L, Hc, C, scale=Hc ** -0.5),
              "cond_b": rnd(L, C, scale=0.1), "step_w": rnd(L, C, C, scale=C ** -0.5),
              "out_w": rnd(L, C, 2 * C, scale=C ** -0.5), "out_b": rnd(L, 2 * C, scale=0.1)}
        kw = den.denoiser_kernel_weights(st)
        x, cond, step = rnd(1, 1000, C), rnd(1, 1000, Hc), rnd(1, C)
        out["denoiser_c256_ms"] = time_ms(lambda: den.fused_residual_stack(x, cond, step, kw), 20)
        ks = (3, 7, 11)
        x = rnd(1, 8000, 256)
        branches = [(mrf.kernel_weights(mrf_weights(256, (k,)), (k,)), (k,)) for k in ks]
        out["mrf_stack_c256_stage_ms"] = time_ms(
            lambda: [mrf.mrf_stack(x, b, k) for b, k in branches], 10)
        for C in (256, 512):
            x = rnd(1, 8000, C)
            whole = mrf.kernel_weights(mrf_weights(C, ks), ks)
            out[f"streamed_c{C}_v1_ms"] = time_ms(lambda: mrf.mrf_stack_streamed(x, whole), 10)
        for name, stages in NARROW_STAGES.items():
            total = 0.0
            for C, T in stages:
                fold = 128 // C
                x = rnd(1, T // fold, fold * C)
                st = dict(mrf.kernel_weights(mrf_weights(C, ks), ks), fold=fold)
                n0 = mrf.mrf_stack_folded.launches
                mrf.mrf_stack_folded(x, st, ks, prefolded=True)
                out[f"{name}_c{C}_launches"] = mrf.mrf_stack_folded.launches - n0
                ms = time_ms(lambda: mrf.mrf_stack_folded(x, st, ks, prefolded=True), 10)
                out[f"{name}_c{C}_ms"] = ms
                total += ms
            out[f"{name}_request_ms"] = total
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
