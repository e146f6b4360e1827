"""Smoke test and first measurement of the PyTorch/CUDA port on one NVIDIA
H100: shallow-mode LJSpeech and AISHELL3 text -> wav through
`mixgantts_tpu_torch`, in fp32 and bf16, with HiFi-GAN and MelGAN, a few
training steps in each mode (aux, naive, shallow), and the train CLI from
aux through the aux -> shallow handoff to a resumed shallow run.

    python3 chip_smoke.py                  # needs one CUDA device
    python3 chip_smoke.py --profile DIR    # keeps the request and train-step traces in DIR

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):
1. build the hand-written kernels (`mixgantts_tpu_torch/csrc/*.cu`, one nvcc
   per source, all started together) and print ptxas's registers, shared
   memory and spills per kernel; count the tensor-core instructions
   (`HGMMA`) in each kernel's SASS (`cuobjdump -sass`): every kernel (the
   denoiser's, the MRF's and the whole-stage MRF kernel's) must hold them
   and spill nothing; print the clusters each cluster kernel holds
   resident at once, and the whole-stage kernel's plan at phase 7's shapes;
2. turn TF32 off for cuDNN convolutions and matmuls (matmul precision
   "highest"), so the plain versions run without TF32, and seed;
3. hold each kernel against its plain PyTorch version at the main path's
   shapes, with the weights of the model in use.  The kernels compute with
   bf16 operands, so their plain versions get the same bf16 weights and
   round where the kernels round; tolerance 4e-3 * max|plain| + 1e-5, one
   bf16 step of the largest value: the same products summed in another
   order, plus bf16 rounding flips of an intermediate (the MRF's conv1
   output, the denoiser's y and g) where the two sums straddle a rounding
   boundary.  The denoiser runs at B in {1, 4} and T in {256, 1000}, and at
   T = 333 (a ragged last tile);
4. build the full LJSpeech shallow model and HiFi-GAN V1 (random weights
   from a seed) on the GPU and serve requests through `TTSPipeline`:
   submit/collect of B=1 with 64 phone slots (frame bucket 1000), then
   `stream` of B=1 and B=4 (32 phone slots, frame bucket 512).  Every
   kernel's launch counter, set to 0 just before, must have moved; the
   waves must be int16 of length mel_len * hop, the mels finite;
5. hold a small request served on the GPU (kernels) against the same
   request served on the CPU (plain versions, same weights, same injected
   noise): with the CPU's denoiser stack and MRF weights also in bf16 (the
   same arithmetic), mel mean |diff| < 1e-3 and the waveform within 16 LSB
   of int16; against the CPU's fp32 path, mel mean |diff| / max|mel| < 0.02
   (the JAX package's bar for its bf16 denoiser, tests/test_pallas.py) and
   the waveform at an SNR above 30 dB (its bar for its bf16 vocoder,
   tests/test_vocoder.py);
6. time each kernel and its plain version with CUDA events, and a request's
   latency and real-time factor with the host clock around work that ends
   in a synchronisation; each bound is taken at the bf16 tensor-core peak
   (the kernels' operand type), with the fp32 bound printed beside it;
7. drive the vocoder's C=256 MRF stage through the whole-stage kernel
   (`mrf_stack_streamed`, bf16, clusters of 4 CTAs) at the shapes of a B=1
   request at bucket 1000 and a B=4 request at bucket 512, hold it against
   its bf16 plain version (the bf16 tolerance), time it in turns beside the
   branchwise route that `fused_apply` takes (three one-branch `mrf_stack`
   calls: branchwise, streamed, streamed, branchwise), print its tile,
   cluster and recompute share, and say which route is faster at both
   shapes beyond the spread of the readings;
8. synthesize from raw text through the CLI (`cli.synthesize`, single and
   batch mode) in a temporary working directory, from a checkpoint of the
   phase-4 weights; the wavs must be int16 at 22050 Hz and mel_len * hop
   long, and every kernel of that path must launch;
9. AISHELL3 multi-speaker shallow at full width (encoder 4, decoder 6,
   hidden 256, denoiser 20x256, universal HiFi-GAN V1, 218 speakers,
   random unit-norm 512-dim DeepSpeaker embeddings, random weights from
   seed 0): a B=1 request with 62 phone slots (frame bucket 1000) and a
   B=4 one with 32 (bucket 512) must launch the denoiser kernel 1 and 2
   times and the MRF kernels as phase 4's requests (18 + 18); the denoiser
   kernel with the speaker term in its conditioner projection against its
   plain version at those shapes (the bf16 tolerance); a small request
   against the CPU at phase 5's bars; latency;
10. `tpu.compute_dtype: bfloat16` LJSpeech requests at phase 4's shapes
   against the fp32 ones on the same weights and injected noise: equal
   lengths, mel mean |diff| < 5% of max|mel| (the JAX package's bf16 bar),
   the same launches, the bf16 HiFi-GAN against the fp32 one on the fp32
   mel at SNR > 30 dB; latency; one traced B=1 request of each type, with
   its cuDNN convolution time;
11. one LJSpeech request vocoded by MelGAN (ngf 32, ratios 8/8/2/2, 80
   mels, random weights from seed 0): its waveform against the CPU's MelGAN
   on the same mel, max |diff| <= 1e-3 with TF32 off; latency; one traced
   request;
and the synthesis CLI from Chinese text (`--dataset AISHELL3 --mode single
--text <hanzi> --speaker_id N`) over a temporary preprocessed directory, on
phase 9's weights; every serving kernel must launch;
12. training at the full width of the LJSpeech configs (fp32, TF32 off,
   random weights from seed 0, the shipped `dga` helper) through
   `mixgantts_tpu_torch.train`: aux and naive at B = batch_size (8),
   shallow at batch_size_shallow (4), synthetic batches from a seed at
   phone bucket 128, word bucket 64, mel bucket 1000 (lengths 600-1000):
   a warm-up step and three timed ones (CUDA events); finite metrics
   (`check_finite_metrics`), every parameter the mode trains moved (D's in
   naive and shallow) and the others not; none of the four kernels'
   counters, set to 0 before the steps, may move (training takes the
   denoiser block by block, as the JAX package's training takes its flax
   blocks); ms per step, peak memory, one traced shallow step with its
   device busy share; then one shallow and one naive step at B=2, T=128
   with dropout off and the same injected t and noise on the GPU and on
   the CPU: losses at rtol 1e-4, each gradient tensor within 1e-3 * max|g|
   on >= 99% of its elements and 1e-2 * max|g| on all (ReLU kinks);
13. the train CLI (`cli.train.main`, in process) at the full width of the
   LJSpeech configs (batch_size 8, batch_size_shallow 4, steps_per_call 8;
   only the paths and the step periods changed: total_step_aux 16,
   total_step_shallow 32, log 4, synth 8, val 16, save 8) on a synthetic
   preprocessed corpus from a seed (96 training utterances of 600-1000
   frames, 32 of 300-500, 8 for validation): aux 0 -> 16, shallow from the
   aux checkpoint at 16 to 32, shallow again from the checkpoint at 24 to
   32, `cli.evaluate` at 32, teacher-forced batch synthesis at 32.  Every
   log line finite, checkpoints 8, 16, 24 and 32 reload, the resumed run's
   losses at steps 28 and 32 within rtol 1e-3 of the uninterrupted run's,
   the denoiser kernel launched in the shallow runs' panels and
   validation, the MRF kernels in both modes', no kernel inside a train
   step, the teacher-forced wavs int16 at 22050 Hz and mel_len * hop long;
   steps/s and mel frames/s per mode (CUDA events around segments, and
   the host clock), each run's wall split into data, steps, panels,
   validation, saving and the rest, checkpoint sizes and write times, peak
   memory, and the kernels' launches per mode and part.

The line before the last is {"kernels": [...]} (per kernel: launches in
phase 4, or phase 7 for `mrf_stack_streamed`; max error in phase 3 or 7;
and the time, plain time and bound of one B=1 request at frame bucket
1000); the last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # H100 SXM, dense bf16 on the tensor cores
BF16_TOL = 4e-3             # the bf16 kernels against their bf16 plain versions
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
DURATION_FRAMES = 8.0       # frames per phone the random duration predictor is biased to
KERNELS = ("residual_stack_mma", "mrf_pair_mma", "mrf_stage_streamed")   # __global__ names
STAGE_SHAPES = ((1, 8000), (4, 4096))   # V1's C=256 stage in a B=1 request at bucket 1000, B=4 at 512
N_SPEAKERS = 218            # AISHELL3's speakers
DEVICE = "cuda"             # the card every phase runs on
# kernel launches of one request of the main path's shapes (B, frame bucket):
# (denoiser, mrf_stack, mrf_stack_folded), as phase 4's requests launch them
REQUEST_LAUNCHES = {(1, 1000): (1, 18, 18), (4, 512): (2, 18, 18)}


def log(*args):
    print(*args, flush=True)


def check_close(name, got, want, rel=1e-4):
    """max|got - want| against rel * max|want| + 1e-5; returns the error."""
    import torch
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    bound = rel * want.abs().max().item() + 1e-5
    log(f"  {name}: max|kernel - plain| = {err:.3e} (allowed {bound:.3e})")
    if err > bound:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def time_ms(fn, iters):
    """Mean device time of fn() in ms over `iters` calls, after warm-up."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warm_up(fn, seconds=0.5):
    """Run fn until `seconds` have passed, so that the card's clocks have
    risen before the first timing of a phase (a couple of calls read up to
    ~20% slow)."""
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()


def bound_ms(flops, nbytes, peak=PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def denoiser_work(B, T, C, Hc, L, weight_bytes=4):
    """FLOP and bytes of `fused_residual_stack` (hoisted projections
    included): inputs read once, outputs written once; conv_w and out_w at
    `weight_bytes` each, the other weights and the activations fp32."""
    flops = L * (2 * B * T * 3 * C * 2 * C      # k = 3 conv, C -> 2C
                 + 2 * B * T * C * 2 * C        # output projection
                 + 2 * B * T * Hc * C           # conditioner projection
                 + 2 * B * C * C)               # step projection
    mma_weights = L * (3 * C * 2 * C + C * 2 * C)
    weights = L * (2 * C + Hc * C + C + C * C + 2 * C)
    nbytes = (4 * (B * T * C + B * T * Hc + B * C + weights + 2 * B * T * C)
              + weight_bytes * mma_weights)
    return flops, nbytes


def mrf_work(B, T, C, kernel_sizes, n_pair=3, weight_bytes=4):
    """FLOP and bytes of one MRF call: per branch and pair two k-tap convs;
    the signal read once and written once in fp32, the weights read once."""
    flops = sum(n_pair * 2 * (2 * k * C * C * B * T) for k in kernel_sizes)
    weights = sum(n_pair * 2 * (weight_bytes * k * C * C + 4 * C) for k in kernel_sizes)
    return flops, 4 * 2 * B * T * C + weights


def mrf_design_bytes(B, T, C, kernel_sizes, n_pair=3):
    """Bytes the one-launch-per-pair design moves through device memory in
    one MRF call: each launch reads its fp32 input and writes its fp32
    output once, the last pair of each later branch also reads the branch
    sum, and each launch reads its bf16 weights once.  Halo re-reads and
    the residual's second read of the tile are not counted (they come from
    L2 when the tile was just read)."""
    signal = 4 * B * T * C
    launches = n_pair * len(kernel_sizes)
    return (2 * launches + len(kernel_sizes) - 1) * signal + sum(
        n_pair * 2 * (2 * k * C * C + 4 * C) for k in kernel_sizes)


def text_batch(B, P, W, seed):
    """Phone ids and word boundaries shaped like the repo's flagship
    example batch (1-3 phones per word)."""
    import numpy as np
    r = np.random.RandomState(seed)
    wb = r.randint(1, 4, (B, W)).astype(np.int64)
    for row in wb:                      # at most P phones in all
        while row.sum() > P:
            row[np.argmax(row)] -= 1
    src_lens = wb.sum(-1)
    texts = np.zeros((B, P), np.int64)
    for b in range(B):
        texts[b, :src_lens[b]] = r.randint(1, 300, src_lens[b])
    return {"speakers": np.zeros(B, np.int64), "texts": texts,
            "src_lens": src_lens, "word_boundaries": wb,
            "src_w_lens": np.full(B, W, np.int64)}


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    """Phase 1: nvcc for every source, then ptxas's report per kernel
    instantiation and each kernel's dynamic shared memory per block."""
    import ctypes
    import re
    from mixgantts_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] {len(cuda_build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for name in cuda_build.SOURCES:
        with open(cuda_build.library_path(name)[:-3] + ".log") as f:
            report = f.read()
        kernel, usage = None, {}
        for line in report.splitlines():
            m = re.search(r"(%s)((?:I(?:Li\d+E)+E)?)" % "|".join(KERNELS), line)
            if m and "entry function" in line:
                args = re.findall(r"Li(\d+)E", m.group(2))
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            elif kernel and ("registers" in line or "spill" in line):
                usage.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
            if "wgmma" in line.lower():     # ptxas's notes on serialised wgmma
                log(f"  ptxas: {line.strip()}")
        for kernel, lines in usage.items():
            log(f"  {kernel}: {'; '.join(lines)}")
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", " ".join(lines))]
            if any(spills):
                raise AssertionError(f"{kernel} spills registers: {lines}")
        hgmma = sass_hgmma(cuda_build.library_path(name))
        for fn, n in hgmma.items():
            log(f"  {fn}: {n} HGMMA instructions in its SASS")
        mma = {fn: n for fn, n in hgmma.items() if fn.startswith(KERNELS)}
        if not mma or not all(mma.values()):
            raise AssertionError(f"the tensor-core kernel's SASS holds no HGMMA: {hgmma}")
        if name == "mrf_stack_streamed":
            from mixgantts_tpu_torch.ops import mrf
            for B, T in STAGE_SHAPES:
                plan = mrf.streamed_plan(B, T)
                log(f"  mrf_stage_streamed at B={B} T={T}: clusters of {plan['cluster']} "
                    f"CTAs, {plan['resident']} clusters resident at once, tile "
                    f"{plan['tile']} frames, {plan['smem']} B of shared memory per CTA, y "
                    f"in a slab of {4 * plan['slab'] / 1e6:.1f} MB")
            continue
        lib = cuda_build.library(name)
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.restype = ctypes.c_int
        if name == "denoiser_stack":
            from mixgantts_tpu_torch.ops import denoiser_stack as den
            smem.argtypes = [ctypes.c_int]
            for c in (128, 256):
                ctas, cluster, resident = den.launch_shape(1, 1000, c)
                log(f"  residual_stack_mma<{c}>: {smem(c)} B of shared memory per CTA, "
                    f"clusters of {cluster} CTAs, {resident} clusters resident at once; "
                    f"{ctas} CTAs per launch at B=1, T=1000")
        else:
            from mixgantts_tpu_torch.ops import mrf
            smem.argtypes = [ctypes.c_int] * 3
            for c in (32, 64, 128, 256):
                log(f"  mrf_pair_mma<{c}, k> shared memory per block at dilation 5, and "
                    f"output frames per block: " + ", ".join(
                        f"k={k}: {smem(c, k, 5)} B, {mrf.tile_frames(c, k)}" for k in (3, 7, 11)))


def sass_hgmma(library):
    """HGMMA (wgmma) instructions per kernel instantiation in a library's
    SASS, from cuobjdump beside nvcc."""
    import re
    from mixgantts_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(%s)((?:I(?:Li\d+E)+E)?)" % "|".join(KERNELS), m.group(1))
            args = re.findall(r"Li(\d+)E", k.group(2)) if k else []
            fn = (k.group(1) + (f"<{', '.join(args)}>" if args else "")) if k else m.group(1)
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def build_serving(torch, device, dataset="LJSpeech"):
    """The full shallow model of a dataset's configs (AISHELL3: N_SPEAKERS
    speakers, DeepSpeaker embeddings) and its HiFi-GAN V1 on `device`, from
    seeds, through the entry points a user calls."""
    from mixgantts_tpu_torch.config import NormStats, get_configs_of
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    pre, cfg, _ = get_configs_of(dataset)
    torch.manual_seed(0)
    model = MixGANTTS.from_configs(
        "shallow", pre, cfg,
        NormStats.default(pre["preprocessing"]["mel"]["n_mel_channels"]),
        n_speakers=N_SPEAKERS if cfg["multi_speaker"] else 1, device=device)
    with torch.no_grad():
        # random weights: durations of a realistic length, and a non-zero
        # denoiser output projection (the reference zero-inits it, which
        # would hide the residual stack from every output check)
        model.linguistic_encoder.duration_predictor.linear_layer.bias.fill_(
            math.log(DURATION_FRAMES))
        out = model.diffusion.denoise_fn.output_projection.conv.weight
        out.copy_(torch.randn(out.shape, generator=torch.Generator().manual_seed(1)) * 0.05)
    vocoder = get_vocoder(cfg, device=device, seed=0)
    return pre, cfg, model, vocoder


def kernel_checks(torch, model, vocoder, records):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    from mixgantts_tpu_torch.ops import mrf
    dev = next(model.parameters()).device
    g = torch.Generator(dev).manual_seed(0)
    stacked = model.diffusion.denoise_fn.stacked()
    C = stacked["conv_w"].shape[-2]
    Hc = stacked["cond_w"].shape[1]
    with torch.no_grad():
        for B, T in ((1, 256), (1, 1000), (4, 256), (4, 1000), (1, 333)):
            x = torch.randn(B, T, C, device=dev, generator=g)
            cond = torch.randn(B, T, Hc, device=dev, generator=g)
            step = torch.randn(B, C, device=dev, generator=g)
            got = den.fused_residual_stack(x, cond, step, stacked)
            want = den.fused_residual_stack_plain(x, cond, step, stacked)  # bf16 weights
            sync(torch)
            rec = records["fused_residual_stack"]
            for part, a, b in zip(("x", "skip"), got, want):
                rec["err"] = max(rec["err"], check_close(
                    f"fused_residual_stack B={B} T={T} {part} (bf16)", a, b, BF16_TOL))

        gen = vocoder.generator
        rks = gen.resblock_kernel_sizes
        dils = gen.resblock_dilation_sizes[0]
        for stage, (C, T, call) in enumerate(mrf_calls(gen, rks, dils, T_mel=1000)):
            x = torch.randn(1, T, C, device=dev, generator=g)
            for name, st, ks, run in call:
                got = run(x)
                want = mrf.mrf_stack_plain(x, st, ks, dils)   # bf16 weights: bf16 arithmetic
                sync(torch)
                rec = records[name]
                rec["err"] = max(rec["err"], check_close(
                    f"{name} stage {stage} C={C} T={T} k={ks} (bf16)", got, want, BF16_TOL))


def mrf_calls(gen, rks, dils, T_mel):
    """The MRF calls of one request at frame bucket T_mel, as
    `models.hifigan.fused_apply` makes them on CUDA, with the stage weights
    it stacks there (bf16, the kernel's layout): per stage (C, T, [(kernel
    name, stacked weights, kernel sizes, fn(x [1, T, C]))])."""
    import torch
    from mixgantts_tpu_torch.models.hifigan import stage_mode, stage_weights
    from mixgantts_tpu_torch.ops import mrf
    out, T, C = [], T_mel, gen.conv_pre.out_channels
    for stage, u in enumerate(gen.upsample_rates):
        T, C = T * u, C // 2
        mode = stage_mode(C, T)
        w = stage_weights(gen, stage, mode, C, torch.bfloat16)
        if mode == "folded":
            fold = w["fold"]
            call = [("mrf_stack_folded", w, rks,
                     lambda x, st=w, fold=fold: mrf.mrf_stack_folded(
                         x.reshape(x.shape[0], x.shape[1] // fold, -1), st, rks,
                         dils, prefolded=True))]
        elif mode == "whole":
            call = [("mrf_stack", w, rks,
                     lambda x, st=w: mrf.mrf_stack(x, st, rks, dils))]
        else:
            call = [("mrf_stack", st, (rk,),
                     lambda x, st=st, rk=rk: mrf.mrf_stack(x, st, (rk,), dils))
                    for st, rk in zip(w, rks)]
        out.append((C, T, call))
    return out


def kernel_timings(torch, model, vocoder, records):
    """Phase 6a: each kernel and its plain version at the shapes of one B=1
    request at frame bucket 1000; bound from the same shapes."""
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    from mixgantts_tpu_torch.ops import mrf
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(1)
    stacked = model.diffusion.denoise_fn.stacked()
    C, Hc, L = stacked["conv_w"].shape[-2], stacked["cond_w"].shape[1], stacked["conv_w"].shape[0]
    with torch.no_grad():
        for B, T in ((1, 1000), (4, 512)):
            x = torch.randn(B, T, C, device=dev, generator=g)
            cond = torch.randn(B, T, Hc, device=dev, generator=g)
            step = torch.randn(B, C, device=dev, generator=g)
            # twice, the plain version's timing between
            launches = den._launch(x, cond, step, stacked)[2]
            warm_up(lambda: den.fused_residual_stack(x, cond, step, stacked))
            ms1 = time_ms(lambda: den.fused_residual_stack(x, cond, step, stacked), 20)
            plain = time_ms(lambda: den.fused_residual_stack_plain(x, cond, step, stacked), 20)
            ms2 = time_ms(lambda: den.fused_residual_stack(x, cond, step, stacked), 20)
            ms = (ms1 + ms2) / 2
            flops, nbytes = denoiser_work(B, T, C, Hc, L, weight_bytes=2)
            b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            b32, by32 = bound_ms(*denoiser_work(B, T, C, Hc, L))
            ctas, cluster, resident = den.launch_shape(B, T, C)
            tflops = flops / ms / 1e9
            log(f"  fused_residual_stack B={B} T={T}: kernel {ms1:.4f}/{ms2:.4f} ms in "
                f"{launches} launch(es); plain (bf16) {plain:.4f} ms, bound {b:.4f} ms at bf16 ({by}), {b32:.4f} ms at fp32 "
                f"({by32}); {tflops:.1f} TFLOP/s ({100 * tflops / (PEAK_BF16_FLOPS / 1e12):.1f}% "
                f"of the bf16 peak); {ctas} CTAs in clusters of {cluster} ({resident} clusters "
                f"resident at once)")
            if (B, T) == (1, 1000):
                records["fused_residual_stack"].update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)

        gen = vocoder.generator
        rks = gen.resblock_kernel_sizes
        dils = gen.resblock_dilation_sizes[0]
        for name in ("mrf_stack", "mrf_stack_folded"):
            records[name].update(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0, nbytes=0)
        for stage, (C, T, call) in enumerate(mrf_calls(gen, rks, dils, T_mel=1000)):
            x = torch.randn(1, T, C, device=dev, generator=g)
            for name, st, ks, run in call:
                ms = time_ms(lambda: run(x), 5)
                plain = time_ms(lambda: mrf.mrf_stack_plain(x, st, ks, dils), 5)
                flops, nbytes = mrf_work(1, T, C, ks, weight_bytes=2)
                b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                b32, by32 = bound_ms(flops, nbytes)
                moved = mrf_design_bytes(1, T, C, ks)
                blocks = [-(-T // mrf.tile_frames(C, k)) for k in ks]
                log(f"  {name} stage {stage} C={C} T={T} k={ks}: kernel {ms:.4f} ms, "
                    f"plain (bf16) {plain:.4f} ms, bound {b:.4f} ms at bf16 ({by}), "
                    f"{b32:.4f} ms at fp32 ({by32}); {flops / ms / 1e9:.1f} TFLOP/s "
                    f"({100 * flops / ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1f}% of the bf16 "
                    f"peak); design moves {moved / 1e6:.1f} MB ({moved / ms / 1e9:.2f} TB/s); "
                    f"blocks per launch {blocks}")
                rec = records[name]
                rec["ms"] += ms
                rec["plain_ms"] += plain
                rec["flops"] += flops
                rec["nbytes"] += nbytes
        for name in ("mrf_stack", "mrf_stack_folded"):
            rec = records[name]
            flops, nbytes = rec.pop("flops"), rec.pop("nbytes")
            rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            log(f"  {name} per request: kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
                f"ms at bf16, {bound_ms(flops, nbytes)[0]:.4f} ms at fp32")


def c256_stage(torch, vocoder, records):
    """Phase 7: the C=256 MRF stage (stage 0) of the vocoder in use, at the
    shapes of a B=1 request at frame bucket 1000 and a B=4 request at
    bucket 512, through the whole-stage kernel (`mrf_stack_streamed` on the
    stage's bf16 weights in the kernel's layout; its launch count is read
    around this drive), held against the bf16 plain version, then timed in
    turns beside the branchwise route (three one-branch `mrf_stack` calls)
    and the plain version, and says whether the whole-stage kernel was
    faster at both shapes beyond the spread of its two readings and the
    branchwise route's two."""
    from mixgantts_tpu_torch.ops import mrf
    gen = vocoder.generator
    rks = gen.resblock_kernel_sizes
    dils = gen.resblock_dilation_sizes[0]
    C = gen.ups[0].out_channels
    whole = mrf.kernel_weights(mrf.stack_mrf_params(gen, 0, rks, dils), rks)
    branches = [(mrf.kernel_weights(
        mrf.stack_mrf_params(gen, 0, (rk,), dils, branches=[(j, rk)]), (rk,)), rk)
        for j, rk in enumerate(rks)]
    g = torch.Generator("cuda").manual_seed(7)
    u = gen.upsample_rates[0]
    shapes = [(B, T_mel * u) for B, T_mel in ((1, 1000), (4, 512))]
    rec = records["mrf_stack_streamed"]
    with torch.no_grad():
        xs = [torch.randn(B, T, C, device="cuda", generator=g) for B, T in shapes]
        mrf.mrf_stack_streamed.launches = 0
        outs = [mrf.mrf_stack_streamed(x, whole, rks, dils) for x in xs]
        sync(torch)
        launches = mrf.mrf_stack_streamed.launches
        log(f"[stage] mrf_stack_streamed launches during the C={C} stage drive: {launches}")
        if launches == 0:
            raise AssertionError("mrf_stack_streamed was not launched on the stage path")
        if not rec["launches"]:
            rec["launches"] = launches
        for (B, T), x, got in zip(shapes, xs, outs):
            rec["err"] = max(rec["err"], check_close(
                f"mrf_stack_streamed B={B} T={T} C={C} (bf16)", got,
                mrf.mrf_stack_plain(x, whole, rks, dils), BF16_TOL))

        def branchwise(x):
            return sum(mrf.mrf_stack(x, st, (rk,), dils) for st, rk in branches) / len(rks)

        warm_up(lambda: branchwise(xs[0]))
        faster = []
        for (B, T), x in zip(shapes, xs):
            # in turns: branchwise, streamed, streamed, branchwise
            bw1 = time_ms(lambda: branchwise(x), 10)
            st1 = time_ms(lambda: mrf.mrf_stack_streamed(x, whole, rks, dils), 10)
            st2 = time_ms(lambda: mrf.mrf_stack_streamed(x, whole, rks, dils), 10)
            bw2 = time_ms(lambda: branchwise(x), 10)
            ms = (st1 + st2) / 2
            plain = time_ms(lambda: mrf.mrf_stack_plain(x, whole, rks, dils), 5)
            flops, nbytes = mrf_work(B, T, C, rks, weight_bytes=2)
            b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            b32, by32 = bound_ms(*mrf_work(B, T, C, rks))
            plan = mrf.streamed_plan(B, T, rks, dils)
            share = mrf.streamed_flops(B, T, rks, dils) / flops
            log(f"  C={C} stage B={B} T={T}: streamed (bf16) {st1:.4f}/{st2:.4f} ms, "
                f"branchwise (bf16) {bw1:.4f}/{bw2:.4f} ms, plain (bf16) {plain:.4f} ms; bound "
                f"{b:.4f} ms at bf16 ({by}), {b32:.4f} ms at fp32 ({by32}); tile "
                f"{plan['tile']} frames per cluster of {plan['cluster']} CTAs "
                f"({-(-T // plan['tile']) * B} clusters, {plan['resident']} resident); "
                f"recompute share "
                f"{share:.3f}; streamed {flops / ms / 1e9:.1f} TFLOP/s of needed work "
                f"({100 * flops / ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1f}% of the bf16 peak)")
            faster.append(max(st1, st2) < min(bw1, bw2))
            if B == 1:
                rec.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"[stage] streamed faster than branchwise beyond the spread of the readings: "
            f"B=1 {faster[0]}, B=4 {faster[1]}; route for C > 128 on CUDA: "
            f"{'streamed' if all(faster) else 'branchwise'}")


def cli_phase(torch, pre, cfg, model):
    """Phase 8: the synthesis CLI from raw text (`mixgantts_tpu_torch.cli.
    synthesize.cli`, in-process), in a temporary working directory that
    holds the phase-4 generator's weights as the reference checkpoint
    `output/ckpt/LJSpeech_shallow/200000.pth.tar`, a lexicon without some
    of the words, `speakers.json`, three `phones_per_word` files and a
    3-line source file: single mode on raw text, then batch mode on the
    source.  Every wav must be int16 at the corpus's rate and mel_len * hop
    long, and every kernel of the path must launch (counts set to 0 just
    before, read just after)."""
    import numpy as np
    from scipy.io import wavfile
    from mixgantts_tpu_torch.cli.synthesize import cli
    from mixgantts_tpu_torch.frontend import preprocess_english
    from mixgantts_tpu_torch.text import sequence_to_text
    counters = kernel_counters()
    hop = pre["preprocessing"]["stft"]["hop_length"]
    sr = pre["preprocessing"]["audio"]["sampling_rate"]
    text = "Dr. Smith read 3 zorblatt pages to the class, didn't he?"
    sources = ["The quick brown fox jumps over the lazy dog.",
               "Mrs. Jones paid 12 dollars for a flumboid teapot!",
               "Hello world"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as ws:
        os.chdir(ws)
        try:
            os.makedirs("output/ckpt/LJSpeech_shallow")
            torch.save({"epoch": 1, "G": {k: v.cpu() for k, v in model.state_dict().items()}},
                       "output/ckpt/LJSpeech_shallow/200000.pth.tar")
            os.makedirs(os.path.dirname(pre["path"]["lexicon_path"]))
            with open(pre["path"]["lexicon_path"], "w") as f:
                f.write("the DH AH0\nto T UW1\nhello HH AH0 L OW1\nworld W ER1 L D\n"
                        "dog D AO1 G\nclass K L AE1 S\n")
            pp = pre["path"]["preprocessed_path"]
            os.makedirs(os.path.join(pp, "phones_per_word"))
            with open(os.path.join(pp, "speakers.json"), "w") as f:
                json.dump({"LJSpeech": 0}, f)
            lines = []
            for i, raw in enumerate(sources):
                seq, wb = preprocess_english(raw, pre, verbose=False)
                np.save(os.path.join(pp, "phones_per_word",
                                     f"LJSpeech-phones_per_word-LJ{i:03d}.npy"), wb)
                lines.append(f"LJ{i:03d}|LJSpeech|{sequence_to_text(seq.tolist())}|{raw}")
            with open("source.txt", "w") as f:
                f.write("\n".join(lines) + "\n")
            common = ["--restore_step", "200000", "--model", "shallow", "--dataset", "LJSpeech"]
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            written = cli(common + ["--mode", "single", "--text", text])
            t_single = time.perf_counter() - t0
            t0 = time.perf_counter()
            written += cli(common + ["--mode", "batch", "--source", "source.txt"])
            t_batch = time.perf_counter() - t0
            sync(torch)
            launches = {name: fn.launches for name, fn in counters.items()}
            for path, mel_len in written:
                rate, wav = wavfile.read(path)
                if rate != sr or wav.dtype != np.int16 or mel_len <= 0 or len(wav) != mel_len * hop:
                    raise AssertionError(f"{path}: {rate} Hz, {wav.dtype}, {len(wav)} "
                                         f"samples, mel_len {mel_len}")
        finally:
            os.chdir(cwd)
    log(f"[cli] wrote {len(written)} wavs (int16, {sr} Hz, mel_len * {hop} samples), "
        f"mel lengths {[n for _, n in written]}; launches {launches}")
    log(f"[cli] text -> written wav, single mode: {t_single:.3f} s wall for the whole "
        f"cli() call (configs, model build, checkpoint restore, synthesis, file); batch "
        f"mode, 3 utterances: {t_batch:.3f} s")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the CLI path")


def serve(torch, pre, cfg, model, vocoder, records):
    """Phase 4: the main path through `TTSPipeline`, with launch counts."""
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    counters = kernel_counters()
    hop = pre["preprocessing"]["stft"]["hop_length"]
    pipe = TTSPipeline(model, vocoder, pre, cfg)
    one = text_batch(1, 64, 24, seed=0)
    four = text_batch(4, 32, 12, seed=1)
    for fn in counters.values():
        fn.launches = 0
    results = [pipe.collect(pipe.submit(one))]
    results += list(pipe.stream([one, four, one, four], depth=2))
    sync(torch)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[serve] launches during {len(results)} requests: {launches}")
    for wavs, mel, lens in results:
        if not np_isfinite(mel):
            raise AssertionError("non-finite mel")
        for wav, n in zip(wavs, lens):
            if wav.dtype.name != "int16" or len(wav) != int(n) * hop or n <= 0:
                raise AssertionError(f"bad wave: {wav.dtype}, {len(wav)} samples, mel_len {n}")
    log(f"[serve] mel lengths: {[r[2].tolist() for r in results]}; buckets "
        f"{[r[1].shape[1] for r in results]}")
    for name, n in launches.items():
        records[name]["launches"] = n
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return pipe, one, four


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def np_isfinite(a):
    import numpy as np
    return bool(np.isfinite(a).all())


def cpu_reference(torch, pre, cfg, model, vocoder, label="reference"):
    """Phase 5 (and 9): one small request on the GPU (kernels) and on the
    CPU (plain versions), same weights and injected noise (and, for a
    multi-speaker model, speaker embedding): the CPU once with its denoiser
    stack and MRF weights in bf16 (the GPU's arithmetic), once in fp32."""
    import numpy as np
    from mixgantts_tpu_torch.config import NormStats
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    cpu_model = MixGANTTS.from_configs(
        "shallow", pre, cfg, NormStats.default(model.n_mels),
        n_speakers=N_SPEAKERS if cfg["multi_speaker"] else 1, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_voc = get_vocoder(cfg, device="cpu")
    cpu_voc.generator.load_state_dict(vocoder.generator.state_dict())
    batch = with_speakers(text_batch(1, 8, 4, seed=2), cfg, seed=2)
    T, M = 128, model.n_mels           # the frame bucket of 8 phone slots
    r = np.random.RandomState(3)
    noise = {"start_noise": r.randn(1, T, M).astype(np.float32),
             "step_noises": r.randn(model.diffusion.num_timesteps, 1, T, M).astype(np.float32)}
    outs = []
    for m, v, dtype in ((model, vocoder, None), (cpu_model, cpu_voc, torch.bfloat16),
                        (cpu_model, cpu_voc, torch.float32)):
        v.generator.mrf_dtype = dtype
        m.diffusion.denoise_fn.stack_dtype = dtype
        pipe = TTSPipeline(m, v, pre, cfg, mel_dtype=torch.float32)
        outs.append(pipe(batch, noise_override=noise))
    cpu_voc.generator.mrf_dtype = None
    cpu_model.diffusion.denoise_fn.stack_dtype = None
    (gw, gm, gl), (bw, bm, bl), (fw, fm, fl) = outs
    if gm.shape != (1, T, M) or not list(gl) == list(bl) == list(fl):
        raise AssertionError(f"GPU/CPU shapes or lengths differ: {gm.shape} {gl} {bl} {fl}")
    mae = float(np.abs(gm - bm).mean())
    mel_rel = float(np.abs(gm - fm).mean() / np.abs(fm).max())
    g, b, f = (w[0].astype(np.float64) for w in (gw, bw, fw))
    lsb = int(np.abs(g - b).max())
    snr = 10 * math.log10((f ** 2).mean() / max(((f - g) ** 2).mean(), 1e-12))
    snr_bf16 = 10 * math.log10((b ** 2).mean() / max(((b - g) ** 2).mean(), 1e-12))
    log(f"[{label}] GPU vs CPU, mel_len {int(gl[0])}: against the CPU with bf16 denoiser "
        f"and MRF weights: mel mean|diff| {mae:.3e} (max|mel| {float(np.abs(bm).max()):.3f}), "
        f"waveform int16 max|diff| {lsb} LSB, SNR {snr_bf16:.1f} dB; against the CPU's fp32 "
        f"path: mel mean|diff| / max|mel| {mel_rel:.3e}, SNR {snr:.1f} dB (int16 max|diff| "
        f"{int(np.abs(g - f).max())} LSB); {len(f)} samples, rms "
        f"{math.sqrt((f ** 2).mean()):.1f}")
    if mae >= 1e-3 or lsb > 16 or mel_rel >= 0.02 or snr <= 30:
        raise AssertionError("GPU path disagrees with the CPU reference")


def latency(torch, pipe, pre, one, four, tag="latency"):
    """Phase 6b (and 9-11): request latency (host clock, ending in
    collect's copy to the host) and real-time factor = latency / audio
    seconds."""
    sr = pre["preprocessing"]["audio"]["sampling_rate"]
    for label, batch, reps in (("B=1 bucket 1000", one, 10), ("B=4 bucket 512", four, 10)):
        if batch is None:
            continue
        pipe(batch)
        times, audio = [], 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            wavs, _, _ = pipe(batch, return_mel=False)
            times.append(time.perf_counter() - t0)
            audio = sum(len(w) for w in wavs) / sr
        med = statistics.median(times)
        log(f"[{tag}] {label}: median {1e3 * med:.2f} ms (min {1e3 * min(times):.2f}, "
            f"max {1e3 * max(times):.2f}) over {reps}; audio {audio:.3f} s; RTF {med / audio:.5f}")


def trace_request(torch, pipe, batch, path, tag="profile", top=15):
    """One traced request (after one untraced): kernel time by name and the
    device's busy share of the wall time, from the chrome trace at `path`.
    Returns {kernel name: device us}."""
    pipe(batch)
    return trace(torch, lambda: pipe(batch, return_mel=False), path, tag, top)


def trace(torch, fn, path, tag, top=15):
    """One traced call of fn: kernel time by name and the device's busy
    share of the wall time (the union of kernel spans), from the chrome
    trace at `path`.  Returns {kernel name: device us}."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    log(f"[{tag}] wall {1e3 * wall:.2f} ms, {len(kernels)} kernels, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / 1e6 / wall:.1f}% of wall), trace {path}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us / 1e3:9.3f} ms  {name[:110]}")
    return by_name


def profile_request(torch, pipe, one, out_dir):
    """One traced B=1 request (`--profile`)."""
    trace_request(torch, pipe, one, os.path.join(out_dir, "request_trace.json"))


def kernel_counters():
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    from mixgantts_tpu_torch.ops import mrf
    return {"fused_residual_stack": den.fused_residual_stack,
            "mrf_stack": mrf.mrf_stack, "mrf_stack_folded": mrf.mrf_stack_folded}


def counted(torch, fn):
    """fn()'s result and the serving kernels' launches during it (counts
    set to 0 just before, read just after a synchronisation)."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    sync(torch)
    return out, tuple(c.launches for c in counters.values())


def with_speakers(batch, cfg, seed):
    """A multi-speaker model's batch gets speaker ids and unit-norm random
    DeepSpeaker-sized embeddings [B, external_speaker_dim] from `seed`."""
    import numpy as np
    if not cfg["multi_speaker"]:
        return batch
    r = np.random.RandomState(seed)
    B = len(batch["texts"])
    emb = r.randn(B, cfg["external_speaker_dim"]).astype(np.float32)
    return dict(batch, speakers=r.randint(0, N_SPEAKERS, B),
                spker_embeds=emb / np.linalg.norm(emb, axis=1, keepdims=True))


def check_request_launches(label, shape, launches):
    want = REQUEST_LAUNCHES[shape]
    log(f"  {label} B={shape[0]} bucket {shape[1]}: launches (denoiser, mrf_stack, "
        f"mrf_stack_folded) {launches}, want {want}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} at {shape}, want {want}")


def aishell3_phase(torch, records):
    """Phase 9: AISHELL3 multi-speaker shallow at full width (DeepSpeaker
    embeddings, N_SPEAKERS speakers, universal HiFi-GAN V1, random weights
    from seed 0) through `TTSPipeline`: launch counts per request, the
    denoiser kernel with the speaker term against its plain version at the
    requests' shapes, a small request against the CPU (phase 5's bars), and
    latency.  Returns (pre, cfg, model) for the Mandarin CLI."""
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    pre, cfg, model, vocoder = build_serving(torch, DEVICE, "AISHELL3")
    log(f"[aishell3] speaker embedding {model.speaker_emb} ({model.embedder_type}); "
        f"max_seq_len {cfg['max_seq_len']}, vocoder {cfg['vocoder']}")
    pipe = TTSPipeline(model, vocoder, pre, cfg)
    one = with_speakers(text_batch(1, 62, 24, seed=3), cfg, seed=3)
    four = with_speakers(text_batch(4, 32, 12, seed=4), cfg, seed=4)
    for batch in (one, four):
        (wavs, mel, lens), launches = counted(torch, lambda: pipe(batch))
        check_request_launches("AISHELL3", (len(lens), mel.shape[1]), launches)
        if not np_isfinite(mel) or any(len(w) != int(n) * 256 or n <= 0 for w, n in zip(wavs, lens)):
            raise AssertionError(f"AISHELL3 request: bad output, lengths {lens}")
        log(f"  mel lengths {lens.tolist()}")
    dev = torch.device(DEVICE)
    stacked = model.diffusion.denoise_fn.stacked()
    g = torch.Generator(dev).manual_seed(9)
    with torch.no_grad():
        for batch, T in ((one, 1000), (four, 512)):
            B = len(batch["texts"])
            spk = model.speaker_embedding(None, torch.as_tensor(batch["spker_embeds"], device=dev))
            spk_proj = den.speaker_projections(spk, stacked)
            x = torch.randn(B, T, 256, device=dev, generator=g)
            cond = torch.randn(B, T, 256, device=dev, generator=g)
            step = torch.randn(B, 256, device=dev, generator=g)
            got = den.fused_residual_stack(x, cond, step, stacked, spk_proj)
            want = den.fused_residual_stack_plain(x, cond, step, stacked, spk_proj)
            sync(torch)
            for part, a, b in zip(("x", "skip"), got, want):
                check_close(f"fused_residual_stack with the speaker term B={B} T={T} {part} (bf16)",
                            a, b, BF16_TOL)
            ms = time_ms(lambda: den.fused_residual_stack(x, cond, step, stacked, spk_proj), 20)
            log(f"  fused_residual_stack with the speaker term B={B} T={T}: {ms:.4f} ms "
                f"(without it: {records['fused_residual_stack'].get('ms', float('nan')):.4f} ms at "
                f"B=1, T=1000 in phase 6)")
    cpu_reference(torch, pre, cfg, model, vocoder, label="aishell3")
    latency(torch, pipe, pre, one, four, tag="aishell3 latency")
    return pre, cfg, model


def bf16_phase(torch, pre, cfg, model, vocoder, out_dir):
    """Phase 10: `tpu.compute_dtype: bfloat16` LJSpeech requests at phase
    4's shapes, against the fp32 pipeline on the bf16 copy's weight values
    and the same injected noise: equal lengths and mel mean |diff| < 5% of
    max|mel| (the JAX package's bar), the same launches, the bf16 HiFi-GAN
    against the fp32 one on the fp32 mel at SNR > 30 dB, latency, and one
    traced B=1 request of each type (device time of cuDNN's convolutions).
    (The fp32 reference takes the bf16-rounded weights because rounding
    random weights moves the predicted durations: a pitch or energy
    prediction that crosses a bin edge picks another embedding row.)"""
    import copy

    import numpy as np
    from mixgantts_tpu_torch.pipeline import TTSPipeline, cast_parameters
    cfg16 = copy.deepcopy(cfg)
    cfg16["tpu"]["compute_dtype"] = "bfloat16"
    rounded = cast_parameters(model, torch.bfloat16, rounded=("",))
    pipe32 = TTSPipeline(rounded, vocoder, pre, cfg, mel_dtype=torch.float32)
    pipe16 = TTSPipeline(model, vocoder, pre, cfg16, mel_dtype=torch.float32)
    one = text_batch(1, 64, 24, seed=0)
    four = text_batch(4, 32, 12, seed=1)
    r = np.random.RandomState(10)
    for batch, T in ((one, 1000), (four, 512)):
        B = len(batch["texts"])
        noise = {"start_noise": r.randn(B, T, 80).astype(np.float32),
                 "step_noises": r.randn(1, B, T, 80).astype(np.float32)}
        (w16, m16, l16), n16 = counted(torch, lambda: pipe16(batch, noise_override=noise))
        (w32, m32, l32), n32 = counted(torch, lambda: pipe32(batch, noise_override=noise))
        check_request_launches("bf16", (B, T), n16)
        check_request_launches("fp32", (B, T), n32)
        rel = float(np.abs(m16 - m32).mean() / np.abs(m32).max())
        with torch.no_grad():
            mel = torch.as_tensor(m32, device=DEVICE)
            ref = vocoder(mel).double()
            low = pipe16.vocoder(mel).double()
        snr = 10 * math.log10((ref ** 2).mean().item() / max(((ref - low) ** 2).mean().item(), 1e-12))
        log(f"  bf16 against fp32 B={B} T={T}: mel lengths {l16.tolist()} / {l32.tolist()}, mel "
            f"mean|diff| / max|mel| {rel:.3e}; HiFi-GAN bf16 against fp32 on the fp32 mel: SNR "
            f"{snr:.1f} dB")
        if list(l16) != list(l32) or rel >= 0.05 or snr <= 30:
            raise AssertionError("the bf16 request disagrees with the fp32 one")
    latency(torch, pipe16, pre, one, four, tag="bf16 latency")
    for tag, pipe in (("fp32", pipe32), ("bf16", pipe16)):
        by_name = trace_request(torch, pipe, one, os.path.join(out_dir, f"{tag}_request_trace.json"),
                                tag=f"{tag} trace", top=8)
        conv = {k: v for k, v in by_name.items()
                if any(s in k.lower() for s in ("conv", "fprop", "dgrad", "cudnn", "xmma"))}
        dgrad = sum(v for k, v in conv.items() if "dgrad" in k.lower())
        log(f"  {tag} request, cuDNN convolution kernels: {sum(conv.values()) / 1e3:.3f} ms "
            f"in {len(conv)} kernel names, of which dgrad (transposed convolution) "
            f"{dgrad / 1e3:.3f} ms:")
        for name, us in sorted(conv.items(), key=lambda kv: -kv[1])[:10]:
            log(f"    {us / 1e3:9.3f} ms  {name[:110]}")


def melgan_phase(torch, pre, cfg, model, out_dir):
    """Phase 11: one LJSpeech request vocoded by MelGAN (ngf 32, ratios
    8/8/2/2, 80 mels, random weights from seed 0): its waveform against the
    CPU's MelGAN on the request's mel (max |diff| <= 1e-3, TF32 off), the
    denoiser's launch, latency, and one traced request."""
    import copy

    import numpy as np
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    mcfg = copy.deepcopy(cfg)
    mcfg["vocoder"] = {"model": "MelGAN", "speaker": "universal"}
    voc = get_vocoder(mcfg, device=DEVICE, seed=0)
    cpu_voc = get_vocoder(mcfg, device="cpu", seed=0)
    pipe = TTSPipeline(model, voc, pre, mcfg, mel_dtype=torch.float32)
    one = text_batch(1, 64, 24, seed=0)
    (wavs, mel, lens), launches = counted(torch, lambda: pipe(one))
    if launches[0] != 1 or any(launches[1:]):
        raise AssertionError(f"MelGAN request launches {launches}: want the denoiser's 1, no MRF")
    if len(wavs[0]) != int(lens[0]) * 256:
        raise AssertionError("MelGAN request: bad waveform length")
    with torch.no_grad():
        got = voc(torch.as_tensor(mel, device=DEVICE)).cpu().double()
        want = cpu_voc(torch.as_tensor(mel)).double()
    err = (got - want).abs().max().item()
    log(f"[melgan] mel length {int(lens[0])}, {len(wavs[0])} samples; GPU against CPU "
        f"waveform max|diff| {err:.3e} (allowed 1e-3), rms {want.pow(2).mean().sqrt().item():.3f}")
    if err > 1e-3:
        raise AssertionError("MelGAN on the GPU disagrees with the CPU")
    latency(torch, pipe, pre, one, None, tag="melgan latency")
    trace_request(torch, pipe, one, os.path.join(out_dir, "melgan_request_trace.json"),
                  tag="melgan trace", top=10)


def mandarin_cli_phase(torch, pre, cfg, model):
    """The synthesis CLI from Chinese text: `--dataset AISHELL3 --mode
    single --text <hanzi> --speaker_id N` in a temporary working directory
    with phase 9's generator as `output/ckpt/AISHELL3_shallow/200000.pth.tar`,
    `speakers.json` of N_SPEAKERS numeric ids, the speaker's
    `spker_embed/{id}-spker_embed.npy` and a small pinyin lexicon; the wav
    must be int16 at the corpus's rate and mel_len * hop long, and every
    serving kernel must launch."""
    import numpy as np
    from scipy.io import wavfile
    from mixgantts_tpu_torch.cli.synthesize import cli
    hop = pre["preprocessing"]["stft"]["hop_length"]
    sr = pre["preprocessing"]["audio"]["sampling_rate"]
    text = "你好，欢迎使用语音合成系统。今天天气很好！"
    speaker_id = 1005
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as ws:
        os.chdir(ws)
        try:
            os.makedirs("output/ckpt/AISHELL3_shallow")
            torch.save({"G": {k: v.cpu() for k, v in model.state_dict().items()}},
                       "output/ckpt/AISHELL3_shallow/200000.pth.tar")
            os.makedirs(os.path.dirname(pre["path"]["lexicon_path"]))
            with open(pre["path"]["lexicon_path"], "w") as f:
                f.write("ni3 n i3\nhao3 h ao3\nhuan1 h uan1\n")
            pp = pre["path"]["preprocessed_path"]
            os.makedirs(os.path.join(pp, "spker_embed"))
            with open(os.path.join(pp, "speakers.json"), "w") as f:
                json.dump({str(1000 + i): i for i in range(N_SPEAKERS)}, f)
            emb = np.random.RandomState(12).randn(1, cfg["external_speaker_dim"]).astype(np.float32)
            np.save(os.path.join(pp, "spker_embed", f"{speaker_id}-spker_embed.npy"),
                    emb / np.linalg.norm(emb))
            argv = ["--restore_step", "200000", "--model", "shallow", "--dataset", "AISHELL3",
                    "--mode", "single", "--text", text, "--speaker_id", str(speaker_id)]
            t0 = time.perf_counter()
            written, launches = counted(torch, lambda: cli(argv))
            t_single = time.perf_counter() - t0
            (path, mel_len), = written
            rate, wav = wavfile.read(path)
        finally:
            os.chdir(cwd)
    log(f"[cli zh] wrote {os.path.basename(path)}: {rate} Hz, {wav.dtype}, {len(wav)} samples, "
        f"mel_len {mel_len}; launches {launches}; {t_single:.3f} s wall for the whole cli() call")
    if rate != sr or wav.dtype != np.int16 or mel_len <= 0 or len(wav) != mel_len * hop:
        raise AssertionError("the Mandarin CLI wrote a bad wav")
    if not all(launches):
        raise AssertionError(f"a serving kernel was not launched on the Mandarin CLI path: {launches}")


# Phase 12: training.  Parameters that may keep their values through the
# steps though their mode trains them: the attention K-projection biases,
# whose gradient is zero by symmetry (softmax is shift-invariant), so only
# rounding noise moves them.  And those a mode does not train: aux mode
# never runs the denoiser; shallow mode detaches the variance predictors'
# outputs, as the JAX package's stop_gradient does.
TRAIN_MAY_STAY = r"(conv_k|w_ks)\.bias$"
TRAIN_FROZEN = {"aux": r"^diffusion\.", "naive": None,
                "shallow": r"(pitch|energy|duration)_predictor\."}
TRAIN_STEPS = 3            # timed steps per mode, after one warm-up step


def train_batch(torch, pre, B, P, W, T, lens, seed, device=None):
    """A synthetic training batch from `seed`, on `device`: B utterances
    with mel lengths in `lens` at frame bucket T, phone bucket P, word
    bucket W (1-2 phones a word); phone durations (each >= 1) summing to
    the mel length; pitch and energy targets inside the stats' ranges;
    mels inside [spec_min, spec_max], zero past the length."""
    import numpy as np
    from mixgantts_tpu_torch.config import NormStats
    from mixgantts_tpu_torch.text.symbols import symbols
    M = pre["preprocessing"]["mel"]["n_mel_channels"]
    stats = NormStats.default(M)
    r = np.random.RandomState(seed)
    mel_lens = r.randint(lens[0], lens[1] + 1, B)
    src_w_lens = r.randint(W // 2, W + 1, B)
    wb = np.zeros((B, W), np.int64)
    texts = np.zeros((B, P), np.int64)
    durations = np.zeros((B, P), np.int64)
    for b in range(B):
        wb[b, :src_w_lens[b]] = r.randint(1, P // W + 1, src_w_lens[b])
        n = int(wb[b].sum())
        texts[b, :n] = r.randint(1, len(symbols), n)
        durations[b, :n] = 1 + r.multinomial(mel_lens[b] - n, np.full(n, 1.0 / n))
    src_lens = wb.sum(1)
    phone_mask = np.arange(P)[None] < src_lens[:, None]
    lo, hi = np.array(stats.spec_min), np.array(stats.spec_max)
    mels = lo + (hi - lo) * r.uniform(size=(B, T, M))
    mels *= (np.arange(T)[None] < mel_lens[:, None])[..., None]
    batch = dict(
        speakers=np.zeros(B, np.int64), texts=texts, src_lens=src_lens, word_boundaries=wb,
        src_w_lens=src_w_lens, mels=mels.astype(np.float32), mel_lens=mel_lens,
        p_targets=(r.uniform(stats.pitch_min, stats.pitch_max, (B, P)) * phone_mask).astype(np.float32),
        e_targets=(r.uniform(stats.energy_min, stats.energy_max, (B, P)) * phone_mask).astype(np.float32),
        d_targets=durations)
    return {k: torch.as_tensor(v, device=device or DEVICE) for k, v in batch.items()}


def build_training(torch, mode, pre, cfg, tc, device=None):
    """G of `mode` and D at the full width of the LJSpeech configs, random
    weights from seed 0, and a fresh train state and step."""
    from mixgantts_tpu_torch.config import NormStats
    from mixgantts_tpu_torch.models.discriminator import JCUDiscriminator
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.train import create_train_state, make_train_step
    torch.manual_seed(0)
    model = MixGANTTS.from_configs(
        mode, pre, cfg, NormStats.default(pre["preprocessing"]["mel"]["n_mel_channels"]),
        device=device or DEVICE)
    disc = JCUDiscriminator.from_configs(pre, cfg, device=device or DEVICE)
    return (model, disc, create_train_state(model, disc, tc, cfg),
            make_train_step(mode, model, disc, cfg, tc))


def all_kernel_counters():
    from mixgantts_tpu_torch.ops import mrf
    return dict(kernel_counters(), mrf_stack_streamed=mrf.mrf_stack_streamed)


def training_phase(torch, out_dir):
    """Phase 12: aux (B = batch_size), naive (batch_size) and shallow
    (batch_size_shallow) training at the full width of the LJSpeech
    configs, on synthetic batches at phone bucket 128, word bucket 64, mel
    bucket 1000 (lengths 600-1000): one warm-up step, then TRAIN_STEPS
    timed ones (CUDA events).  The metrics must be finite, every parameter
    the mode trains must move (D's too in naive and shallow) and the
    others not, and no kernel may launch during the steps.  Median ms per
    step, peak memory, and one traced shallow step with its device busy
    share; then one shallow and one naive step against the CPU."""
    import re
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.train import check_finite_metrics
    pre, cfg, tc = get_configs_of("LJSpeech")
    counters = all_kernel_counters()
    for mode in ("aux", "naive", "shallow"):
        B = tc["optimizer"]["batch_size_shallow" if mode == "shallow" else "batch_size"]
        model, disc, state, step_fn = build_training(torch, mode, pre, cfg, tc)
        batch = train_batch(torch, pre, B, 128, 64, 1000, (600, 1000), seed=12)
        named = [("G " + n, p) for n, p in model.named_parameters()]
        if mode != "aux":
            named += [("D " + n, p) for n, p in disc.named_parameters()]
        before = [p.detach().clone() for _, p in named]
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()   # this mode's G, D and batch, and earlier phases'
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        check_finite_metrics(step_fn(state, batch), state.step)          # warm-up
        warm = time.perf_counter() - t0
        times, wall = [], []
        for _ in range(TRAIN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            metrics = step_fn(state, batch)
            end.record()
            check_finite_metrics(metrics, state.step)                     # copies to the host
            wall.append(1e3 * (time.perf_counter() - t0))
            times.append(start.elapsed_time(end))
        sync(torch)
        launches = {name: c.launches for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        frames = int(batch["mel_lens"].sum())
        med = statistics.median(times)
        log(f"[train] {mode} B={B} bucket 1000 ({frames} frames): "
            f"{statistics.median(wall):.2f} ms per step on the host clock, device "
            f"{med:.2f} ms (CUDA events; {', '.join(f'{x:.2f}' for x in times)}), "
            f"{1e3 * frames / med:.0f} mel frames/s; warm-up step {1e3 * warm:.0f} ms; "
            f"peak memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB over the "
            f"{base / 2**30:.2f} GiB allocated before the steps; "
            + ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(metrics.items())))
        if any(launches.values()):
            raise AssertionError(f"{mode} training launched a serving kernel: {launches}")
        frozen, still, moved_frozen = TRAIN_FROZEN[mode], [], []
        for (name, p), p0 in zip(named, before):
            moved = not torch.equal(p.detach(), p0)
            if frozen and re.search(frozen, name.split(" ", 1)[1]):
                if moved:
                    moved_frozen.append(name)
            elif not moved and not re.search(TRAIN_MAY_STAY, name):
                still.append(name)
        log(f"  {len(named)} parameter tensors, none of the serving kernels launched "
            f"({launches})")
        if still or moved_frozen:
            raise AssertionError(f"{mode}: trained parameters that did not move {still[:8]}, "
                                 f"frozen ones that moved {moved_frozen[:8]}")
        if mode == "shallow":
            trace(torch, lambda: step_fn(state, batch),
                  os.path.join(out_dir, "shallow_train_step_trace.json"), "train trace")
        del model, disc, state, step_fn, batch, before, named
        torch.cuda.empty_cache()
    train_cpu_reference(torch, pre, cfg, tc)


def train_cpu_reference(torch, pre, cfg, tc):
    """Phase 12b: one shallow and one naive step at B=2, T=128 on the
    full-width model (a non-zero denoiser output projection, so the
    residual stack's gradients show), TF32 off, dropout p = 0, the same
    injected t and noise, on the GPU and on the CPU from the same weights:
    every loss at rtol 1e-4; every gradient tensor of G and D within
    1e-3 * max|g| on >= 99% of its elements and within 1e-2 * max|g| on
    all (a ReLU input within rounding of 0 passes the gradient on one
    device and not on the other, which moves a whole row of the next
    weight's gradient: in the decoder's FFN one such row was 0.098% of
    w_1's elements, off by up to 2.5e-3 of max|g|), max|g|
    floored at 1e-3 of the model's largest gradient (the K-projection and
    PostNet conv biases have a zero gradient by symmetry, softmax's shift
    invariance and BatchNorm's mean, so theirs is rounding noise on both
    devices)."""
    import numpy as np
    for mode in ("shallow", "naive"):
        devices = (DEVICE, "cpu")
        built = [build_training(torch, mode, pre, cfg, tc, device) for device in devices]
        gpu_model, gpu_disc = built[0][:2]
        with torch.no_grad():
            out = gpu_model.diffusion.denoise_fn.output_projection.conv.weight
            out.copy_(torch.randn(out.shape, generator=torch.Generator().manual_seed(1)) * 0.05)
        batches = [train_batch(torch, pre, 2, 32, 16, 128, (100, 128), seed=13, device=device)
                   for device in devices]
        r = np.random.RandomState(14)
        shape = tuple(batches[0]["mels"].shape)
        noise = [{"t": r.randint(0, gpu_model.diffusion.num_timesteps, 2),
                  **{k: r.randn(*shape).astype(np.float32)
                     for k in ("x_t_noise", "x_t_prev_noise", "posterior_noise")}}
                 for _ in range(2)]
        init = [{k: v.clone() for k, v in m.state_dict().items()} for m in (gpu_model, gpu_disc)]
        runs = []
        for (model, disc, state, step_fn), batch, device in zip(built, batches, devices):
            model.load_state_dict(init[0])
            disc.load_state_dict(init[1])
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
            metrics = step_fn(state, batch, noise_overrides=[
                {k: torch.as_tensor(v, device=device) for k, v in n.items()} for n in noise])
            grads = {f"{tag} {n}": (p.grad.detach().cpu() if p.grad is not None
                                     else torch.zeros(p.shape))
                     for tag, m in (("G", model), ("D", disc)) for n, p in m.named_parameters()}
            runs.append(({k: float(v) for k, v in metrics.items()}, grads))
        (gm, gg), (cm, cg) = runs
        bad = [k for k in cm if abs(gm[k] - cm[k]) > 1e-4 * abs(cm[k]) + 1e-6]
        worst, worst_frac, failed = 0.0, 0.0, []
        for tag in ("G", "D"):
            names = [k for k in cg if k.startswith(tag)]
            top = max(float(cg[k].abs().max()) for k in names)
            for k in names:
                bar = max(float(cg[k].abs().max()), 1e-3 * top)
                diff = (gg[k] - cg[k]).abs()
                frac = float((diff > 1e-3 * bar).float().mean())
                worst = max(worst, float(diff.max()) / bar)
                worst_frac = max(worst_frac, frac)
                if frac > 1e-2 or float(diff.max()) > 1e-2 * bar:
                    failed.append(f"{k} max|diff| {float(diff.max()):.3g}, {frac:.2%} of "
                                  f"elements past 1e-3 * {bar:.3g}")
        log(f"[train cpu] {mode} B=2 T=128, GPU against CPU: losses "
            + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(cm))
            + f"; gradients of {len(cg)} tensors: worst max|diff| / max|g| {worst:.3e}, "
            f"worst share of elements past 1e-3 * max|g| {worst_frac:.2e}")
        if bad or failed:
            raise AssertionError(f"{mode}: the GPU step disagrees with the CPU step: "
                                 f"losses {bad}, gradients {failed[:6]}")


# Phase 13: the train CLI.  Its step periods (the shipped configs' other
# values are kept), and the synthetic corpus: (list, utterances, mel length
# range).  Two mel buckets (512 and 1000) in train.txt.
TRAIN_CLI_STEPS = {"total_step_aux": 16, "total_step_shallow": 32, "log_step": 4,
                   "synth_step": 8, "val_step": 16, "save_step": 8}
TRAIN_CLI_CORPUS = (("train.txt", 96, (600, 1000)), ("train.txt", 32, (300, 500)),
                    ("val.txt", 8, (600, 1000)))
CLI_PARTS = ("data", "steps", "panels", "validation", "saving")


def write_corpus(pp, n_mels, plan=TRAIN_CLI_CORPUS, seed=13):
    """A synthetic preprocessed corpus under `pp`, with numpy from `seed`,
    in the files the JAX preprocessor writes (`mixgantts_tpu/data/
    preprocessor.py:199-227`): per utterance mel [T, n_mels] float32 inside
    [spec_min, spec_max], phone-level pitch and energy inside the stats'
    ranges, durations (each >= 1) summing to T, phones per word (1-6),
    attn_prior [P, T]; ~7 frames a phone, as LJSpeech speaks; train.txt and
    val.txt lines "basename|speaker|{phones}|raw text", speakers.json and
    stats.json (the placeholder statistics of `NormStats.default`)."""
    import numpy as np
    from mixgantts_tpu_torch.config import NormStats
    from mixgantts_tpu_torch.text.cmudict import valid_symbols
    stats = NormStats.default(n_mels)
    r = np.random.RandomState(seed)
    for kind in ("mel", "pitch", "energy", "duration", "phones_per_word", "attn_prior"):
        os.makedirs(os.path.join(pp, kind), exist_ok=True)
    lines = {}
    for name, count, (lo, hi) in plan:
        for _ in range(count):
            base = f"LJ{sum(len(v) for v in lines.values()):04d}"
            T = int(r.randint(lo, hi + 1))
            P = int(T / r.uniform(6.0, 8.0))
            words = []
            while sum(words) < P:
                words.append(min(int(r.randint(1, 7)), P - sum(words)))
            prior = r.uniform(0.05, 1.0, (P, T)).astype(np.float32)
            arrays = {
                "mel": (stats.spec_min[0] + (stats.spec_max[0] - stats.spec_min[0])
                        * r.uniform(size=(T, n_mels))).astype(np.float32),
                "pitch": r.uniform(stats.pitch_min, stats.pitch_max, P),
                "energy": r.uniform(stats.energy_min, stats.energy_max, P),
                "duration": 1 + r.multinomial(T - P, np.full(P, 1.0 / P)),
                "phones_per_word": np.array(words, np.int64),
                "attn_prior": prior / prior.sum(0, keepdims=True),
            }
            for kind, a in arrays.items():
                np.save(os.path.join(pp, kind, f"LJSpeech-{kind}-{base}.npy"), a)
            phones = " ".join(r.choice(valid_symbols, P))
            lines.setdefault(name, []).append(
                f"{base}|LJSpeech|{{{phones}}}|a synthetic utterance of {T} frames")
    for name, rows in lines.items():
        with open(os.path.join(pp, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(pp, "speakers.json"), "w") as f:
        json.dump({"LJSpeech": 0}, f)
    with open(os.path.join(pp, "stats.json"), "w") as f:
        json.dump({"pitch": [stats.pitch_min, stats.pitch_max, stats.pitch_mean,
                             stats.pitch_std],
                   "energy": [stats.energy_min, stats.energy_max, stats.energy_mean,
                              stats.energy_std],
                   "spec_min": list(stats.spec_min), "spec_max": list(stats.spec_max),
                   "max_seq_len": plan[0][2][1]}, f)


class CLIMeter:
    """Wraps the train CLI's parts (`cli.train`'s module attributes) for
    one phase: host seconds of each part (`CLI_PARTS`: the loop's waits for
    a batch, the segments, the sample panels outside validation,
    validation, checkpoint writes), the four kernels' launches in each
    part per mode, each segment's CUDA events, steps and mel frames, the
    losses behind each log line per run, and each checkpoint's size and
    write time.  A part ends in a synchronisation, so its host time holds
    its device work."""

    def __init__(self, torch, counters):
        self.torch, self.counters = torch, counters
        self.run = self.mode = None
        self.time = {}          # (run, part) -> s
        self.launches = {}      # (mode, part) -> {kernel: launches}
        self.segments = []      # (mode, start event, end event, steps, frames, host s)
        self.losses = {}        # (run, step) -> {loss: value}
        self.saves = []         # (path, bytes, s)
        self.waits = {}         # run -> [s of each wait for a batch]
        self._validating = False

    def _counts(self):
        return {name: c.launches for name, c in self.counters.items()}

    def _add(self, part, seconds, before):
        key = (self.run, part)
        self.time[key] = self.time.get(key, 0.0) + seconds
        if before is not None:
            counts = self.launches.setdefault((self.mode, part), dict.fromkeys(self.counters, 0))
            for name, n in self._counts().items():
                counts[name] += n - before[name]

    def part(self, name, fn):
        def wrapped(*args, **kwargs):
            if name == "panels" and self._validating:    # validation's own panel
                return fn(*args, **kwargs)
            self._validating = name == "validation"
            before, t0 = self._counts(), time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                sync(self.torch)
            finally:
                self._validating = False
            self._add(name, time.perf_counter() - t0, before)
            return out
        return wrapped

    def save(self, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            path = fn(*args, **kwargs)
            seconds = time.perf_counter() - t0
            self._add("saving", seconds, None)
            self.saves.append((path, os.path.getsize(path), seconds))
            return path
        return wrapped

    def prefetch(self, fn):
        def wrapped(iterator, size=2):
            items = fn(iterator, size)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(items)
                except StopIteration:
                    return
                finally:
                    self._add("data", time.perf_counter() - t0, None)
                    self.waits.setdefault(self.run, []).append(time.perf_counter() - t0)
                yield item
        return wrapped

    def chunk_train_step(self, fn):
        torch = self.torch

        def make(step_fn):
            chunk_fn = fn(step_fn)

            def wrapped(state, batches):
                before, t0 = self._counts(), time.perf_counter()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                out = chunk_fn(state, batches)
                end.record()
                sync(torch)
                seconds = time.perf_counter() - t0
                self._add("steps", seconds, before)
                self.segments.append((self.mode, start, end, len(batches["mel_lens"]),
                                      int(batches["mel_lens"].sum()), seconds))
                return out
            return wrapped
        return make

    def loss_message(self, fn):
        def wrapped(step, total_step, losses):
            self.losses[(self.run, step)] = {k: float(v) for k, v in losses.items()}
            return fn(step, total_step, losses)
        return wrapped


def train_cli_phase(torch, device=DEVICE, dataset="LJSpeech", plan=TRAIN_CLI_CORPUS):
    """Phase 13: the train CLI (`cli.train.main`, in process) at the full
    width of the shipped configs of `dataset`, in a temporary workspace
    that holds them with `TRAIN_CLI_STEPS` and a synthetic corpus
    (`write_corpus`): aux 0 -> 16; shallow from the aux checkpoint at 16
    to 32; shallow again from the checkpoint at 24 to 32; `cli.evaluate`
    at 32; `cli.synthesize --mode batch --teacher_forced` at 32.  Every
    log line must be finite, checkpoints 8, 16, 24 and 32 must reload, the
    resumed run's losses at 28 and 32 must be within rtol 1e-3 of the
    uninterrupted run's, the denoiser kernel must launch in the shallow
    runs' panels and validation, the MRF kernels in both modes', no kernel
    inside a train step, and the teacher-forced wavs must be int16 at the
    corpus's rate and mel_len * hop long."""
    import re
    import numpy as np
    import yaml
    from scipy.io import wavfile
    from mixgantts_tpu_torch.checkpoint import restore_checkpoint
    from mixgantts_tpu_torch.cli import common, evaluate, synthesize
    from mixgantts_tpu_torch.cli import train as cli_train
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.train import create_train_state
    from mixgantts_tpu_torch.utils.logging import MESSAGE_KEYS
    pre, cfg, tc = get_configs_of(dataset)
    tc["step"].update(TRAIN_CLI_STEPS)
    counters = all_kernel_counters()
    meter = CLIMeter(torch, counters)
    wrappers = {"prefetch": meter.prefetch, "chunk_train_step": meter.chunk_train_step,
                "synthesize_sample": lambda fn: meter.part("panels", fn),
                "evaluate": lambda fn: meter.part("validation", fn),
                "save_checkpoint": meter.save, "loss_message": meter.loss_message}
    originals = {name: getattr(cli_train, name) for name in wrappers}
    runs = (("aux 0-16", "aux", 0), ("shallow 16-32", "shallow", 16),
            ("shallow 24-32 (resumed)", "shallow", 24))
    cwd = os.getcwd()
    walls, peaks = {}, {}
    with tempfile.TemporaryDirectory() as ws:
        os.chdir(ws)
        try:
            cfg_dir = os.path.join("config", dataset)
            os.makedirs(cfg_dir)
            for name, c in (("preprocess.yaml", pre), ("model.yaml", cfg), ("train.yaml", tc)):
                with open(os.path.join(cfg_dir, name), "w") as f:
                    yaml.safe_dump(c, f)
            t0 = time.perf_counter()
            write_corpus(pre["path"]["preprocessed_path"],
                         pre["preprocessing"]["mel"]["n_mel_channels"], plan)
            log(f"[train cli] corpus: {sum(n for _, n, _ in plan)} utterances "
                f"({', '.join(f'{n} of {lo}-{hi} frames in {name}' for name, n, (lo, hi) in plan)})"
                f", written in {time.perf_counter() - t0:.2f} s; steps {TRAIN_CLI_STEPS}, "
                f"batch {tc['optimizer']['batch_size']} (shallow "
                f"{tc['optimizer']['batch_size_shallow']}), steps_per_call "
                f"{cfg['tpu']['steps_per_call']}")
            for name, fn in wrappers.items():
                setattr(cli_train, name, fn(originals[name]))
            for label, mode, restore in runs:
                meter.run, meter.mode = label, mode
                args = argparse.Namespace(model=mode, dataset=dataset, restore_step=restore,
                                          path_tag="", seed=0)
                configs = common.load_configs(args)
                if torch.cuda.is_available():
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                cli_train.main(args, configs, device)
                walls[label] = time.perf_counter() - t0
                peaks[label] = (torch.cuda.max_memory_allocated()
                                if torch.cuda.is_available() else 0)
            for name, fn in originals.items():
                setattr(cli_train, name, fn)
            tc_shallow = configs[2]
            ckpt_path, log_path = tc_shallow["path"]["ckpt_path"], tc_shallow["path"]["log_path"]

            t0 = time.perf_counter()
            message = evaluate.cli(["--restore_step", "32", "--model", "shallow",
                                    "--dataset", dataset], device=device)
            t_eval = time.perf_counter() - t0
            t0 = time.perf_counter()
            written = synthesize.cli(["--restore_step", "32", "--model", "shallow", "--mode",
                                      "batch", "--teacher_forced", "--dataset", dataset],
                                     device=device)
            t_tf = time.perf_counter() - t0

            numbers = []
            for part in ("train", "val"):
                with open(os.path.join(log_path, part, "log.txt")) as f:
                    lines = f.read().splitlines()
                numbers += [float(x) for line in lines
                            for x in re.findall(r"-?\d+\.\d+|nan|inf", line.split(", ", 1)[1])]
                log(f"[train cli] {part}/log.txt: {len(lines)} lines, the last: {lines[-1]}")
            if not numbers or not np.isfinite(numbers).all():
                raise AssertionError("a log line is not finite")
            for step, mode in ((8, "aux"), (16, "aux"), (24, "shallow"), (32, "shallow")):
                model, _ = common.build_model(mode, pre, cfg, device=device)
                disc = common.build_discriminator(pre, cfg, device=device)
                state = create_train_state(model, disc, tc, cfg)
                restore_checkpoint(ckpt_path, state, step)
                if state.step != step:
                    raise AssertionError(f"checkpoint {step} restored step {state.step}")
                del model, disc, state
            hop = pre["preprocessing"]["stft"]["hop_length"]
            sr = pre["preprocessing"]["audio"]["sampling_rate"]
            for path, mel_len in written:
                rate, wav = wavfile.read(path)
                if rate != sr or wav.dtype != np.int16 or mel_len <= 0 or len(wav) != mel_len * hop:
                    raise AssertionError(f"{path}: {rate} Hz, {wav.dtype}, {len(wav)} "
                                         f"samples, mel_len {mel_len}")
        finally:
            for name, fn in originals.items():
                setattr(cli_train, name, fn)
            os.chdir(cwd)

    worst = 0.0
    for step in (28, 32):
        want, got = meter.losses[(runs[1][0], step)], meter.losses[(runs[2][0], step)]
        for k in MESSAGE_KEYS:
            err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
            worst = max(worst, err if abs(got[k] - want[k]) > 1e-6 else 0.0)
        log(f"[train cli] step {step}, resumed / uninterrupted: "
            + ", ".join(f"{k} {got[k]:.6f}/{want[k]:.6f}" for k in MESSAGE_KEYS))
    if worst > 1e-3:
        raise AssertionError(f"the resumed run's losses differ by {worst:.3e} (rtol 1e-3)")
    log(f"[train cli] resumed against uninterrupted at steps 28 and 32: worst relative "
        f"difference {worst:.3e} (rtol 1e-3)")
    log(f"[train cli] checkpoints 8, 16, 24, 32 reload; evaluate at 32 ({t_eval:.2f} s): "
        f"{message}; teacher-forced synthesis ({t_tf:.2f} s): {len(written)} wavs, int16 at "
        f"{sr} Hz, mel_len * {hop} samples")

    for mode in ("aux", "shallow"):
        segs = [s for s in meter.segments if s[0] == mode]
        device_ms = sum(start.elapsed_time(end) for _, start, end, _, _, _ in segs)
        host_s = sum(s[5] for s in segs)
        steps, frames = sum(s[3] for s in segs), sum(s[4] for s in segs)
        per_step = [f"{start.elapsed_time(end) / n:.1f}" for _, start, end, n, _, _ in segs]
        log(f"[train cli] {mode}: {steps} steps in {len(segs)} segments (lengths "
            f"{[s[3] for s in segs]}, ms a step {per_step}): {1e3 * steps / device_ms:.2f} "
            f"steps/s and "
            f"{1e3 * frames / device_ms:.0f} mel frames/s on CUDA events "
            f"({device_ms / steps:.2f} ms a step); {steps / host_s:.2f} steps/s and "
            f"{frames / host_s:.0f} mel frames/s on the host clock")
    for label, _, _ in runs:
        shares = {part: meter.time.get((label, part), 0.0) for part in CLI_PARTS}
        other = walls[label] - sum(shares.values())
        log(f"[train cli] {label}: wall {walls[label]:.2f} s; "
            + ", ".join(f"{part} {100 * s / walls[label]:.1f}%" for part, s in shares.items())
            + f", other (model and vocoder build, restore, logging) "
            f"{100 * other / walls[label]:.1f}%; peak memory {peaks[label] / 2**30:.2f} GiB")
        waits = sorted(meter.waits.get(label, []), reverse=True)
        log(f"  {len(waits)} batches taken, waits over 10 ms: "
            f"{[f'{1e3 * w:.0f}' for w in waits if w > 0.01]} ms")
    sizes = sorted({(os.path.basename(p), n) for p, n, _ in meter.saves})
    log(f"[train cli] checkpoints {sizes}: "
        + ", ".join(f"{n / 2**20:.1f} MiB in {1e3 * s:.0f} ms" for _, n, s in meter.saves))
    for (mode, part), counts in sorted(meter.launches.items()):
        log(f"[train cli] launches, {mode} {part}: {counts}")
    steps_launched = {k: v for (mode, part), c in meter.launches.items() if part == "steps"
                      for k, v in c.items() if v}
    if steps_launched:
        raise AssertionError(f"a kernel launched inside a train step: {steps_launched}")
    for mode in ("aux", "shallow"):
        for part in ("panels", "validation"):
            counts = meter.launches.get((mode, part), {})
            want = ["mrf_stack", "mrf_stack_folded"] + (
                ["fused_residual_stack"] if mode == "shallow" else [])
            missing = [k for k in want if not counts.get(k)]
            if missing:
                raise AssertionError(f"{mode} {part}: {missing} did not launch ({counts})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace one B=1 request into DIR, and keep phases 10-12's traces there")
    args = parser.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    gpu = gpu_line()
    log(f"[env] {gpu}")

    build_kernels()                                               # phase 1
    torch.backends.cudnn.allow_tf32 = False                       # phase 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.manual_seed(0)

    pre, cfg, model, vocoder = build_serving(torch, "cuda")
    sources = {"fused_residual_stack": ("mixgantts_tpu_torch/csrc/denoiser_stack.cu",
                                        "mixgantts_tpu/ops/pallas.py:122"),
               "mrf_stack": ("mixgantts_tpu_torch/csrc/mrf_stack.cu",
                             "mixgantts_tpu/ops/pallas_vocoder.py:528"),
               "mrf_stack_folded": ("mixgantts_tpu_torch/csrc/mrf_stack.cu",
                                    "mixgantts_tpu/ops/pallas_vocoder.py:303"),
               "mrf_stack_streamed": ("mixgantts_tpu_torch/csrc/mrf_stack_streamed.cu",
                                      "mixgantts_tpu/ops/pallas_vocoder.py:461")}
    records = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "err": 0.0}
               for name, (src, rep) in sources.items()}
    log("[check] kernels against their plain versions (TF32 off)")
    kernel_checks(torch, model, vocoder, records)                 # phase 3
    pipe, one, four = serve(torch, pre, cfg, model, vocoder, records)   # phase 4
    cpu_reference(torch, pre, cfg, model, vocoder)                # phase 5
    log("[time] kernels and plain versions, one B=1 request at bucket 1000")
    kernel_timings(torch, model, vocoder, records)                # phase 6
    latency(torch, pipe, pre, one, four)
    if args.profile:
        profile_request(torch, pipe, one, args.profile)
    log("[stage] the C=256 MRF stage in one launch (bf16, TF32 off), beside the "
        "branchwise route")
    c256_stage(torch, vocoder, records)                           # phase 7
    log("[cli] raw text -> wav files through the synthesis CLI")
    cli_phase(torch, pre, cfg, model)                             # phase 8
    log("[aishell3] AISHELL3 multi-speaker shallow at full width, DeepSpeaker embeddings")
    zh = aishell3_phase(torch, records)                           # phase 9
    log("[bf16] tpu.compute_dtype bfloat16: LJSpeech requests against fp32")
    with tempfile.TemporaryDirectory() as tmp:
        bf16_phase(torch, pre, cfg, model, vocoder, args.profile or tmp)   # phase 10
        log("[melgan] one LJSpeech request vocoded by MelGAN")
        melgan_phase(torch, pre, cfg, model, args.profile or tmp)          # phase 11
    log("[cli zh] Chinese text -> wav through the synthesis CLI, AISHELL3")
    mandarin_cli_phase(torch, *zh)
    log("[train] aux, naive and shallow training at full width (fp32, TF32 off)")
    with tempfile.TemporaryDirectory() as tmp:
        training_phase(torch, args.profile or tmp)                # phase 12
    log("[train cli] the train CLI at full width: aux, the aux -> shallow handoff, resume")
    train_cli_phase(torch)                                        # phase 13

    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"],
                "replaces": r["replaces"], "launches": r["launches"],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
               for r in records.values()]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
