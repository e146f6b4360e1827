"""Smoke test and first measurement of the PyTorch/CUDA port on one NVIDIA
H100: shallow-mode LJSpeech text -> wav through `mixgantts_tpu_torch`.

    python3 chip_smoke.py                  # needs one CUDA device
    python3 chip_smoke.py --profile DIR    # also traces one request into DIR

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):
1. build the hand-written kernels (`mixgantts_tpu_torch/csrc/*.cu`, one nvcc
   per source, all started together) and print ptxas's registers, shared
   memory and spills per kernel;
2. turn TF32 off for cuDNN convolutions and matmuls (matmul precision
   "highest"), so every plain version runs in full fp32, and seed;
3. hold each kernel against its plain PyTorch version at the main path's
   shapes, with the weights of the model in use.  Tolerance:
   max|kernel - plain| <= 1e-4 * max|plain| + 1e-5 (fp32 sums in another
   order; the denoiser kernel also adds across blocks with atomics);
4. build the full LJSpeech shallow model and HiFi-GAN V1 (random weights
   from a seed) on the GPU and serve requests through `TTSPipeline`:
   submit/collect of B=1 with 64 phone slots (frame bucket 1000), then
   `stream` of B=1 and B=4 (32 phone slots, frame bucket 512).  Every
   kernel's launch counter, set to 0 just before, must have moved; the
   waves must be int16 of length mel_len * hop, the mels finite;
5. hold a small request served on the GPU (kernels) against the same
   request served on the CPU (plain versions, same weights, same injected
   noise): mel mean |diff| < 1e-3 and int16 samples within 16 LSB;
6. time each kernel and its plain version with CUDA events, and a request's
   latency and real-time factor with the host clock around work that ends
   in a synchronisation;
7. drive the vocoder's C=256 MRF stage through the whole-stage kernel
   (`mrf_stack_streamed`) at the shapes of a B=1 request at bucket 1000
   and a B=4 request at bucket 512, hold it against its plain version
   (same tolerance), and time it beside the branchwise route that
   `fused_apply` takes (three one-branch `mrf_stack` calls);
8. synthesize from raw text through the CLI (`cli.synthesize`, single and
   batch mode) in a temporary working directory, from a checkpoint of the
   phase-4 weights; the wavs must be int16 at 22050 Hz and mel_len * hop
   long, and every kernel of that path must launch.

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
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
DURATION_FRAMES = 8.0       # frames per phone the random duration predictor is biased to


def log(*args):
    print(*args, flush=True)


def check_close(name, got, want):
    """max|got - want| against 1e-4 * max|want| + 1e-5; returns the error."""
    import torch
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    bound = 1e-4 * want.abs().max().item() + 1e-5
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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def denoiser_work(B, T, C, Hc, L):
    """FLOP and bytes of `fused_residual_stack` (hoisted projections
    included): inputs read once, outputs written once."""
    flops = L * (2 * B * T * 3 * C * 2 * C      # k = 3 conv, C -> 2C
                 + 2 * B * T * C * 2 * C        # output projection
                 + 2 * B * T * Hc * C           # conditioner projection
                 + 2 * B * C * C)               # step projection
    weights = L * (3 * C * 2 * C + 2 * C + Hc * C + C + C * C + C * 2 * C + 2 * C)
    nbytes = 4 * (B * T * C + B * T * Hc + B * C + weights + 2 * B * T * C)
    return flops, nbytes


def mrf_work(B, T, C, kernel_sizes, n_pair=3):
    """FLOP and bytes of one MRF call: per branch and pair two k-tap convs."""
    flops = sum(n_pair * 2 * (2 * k * C * C * B * T) for k in kernel_sizes)
    weights = sum(n_pair * 2 * (k * C * C + C) for k in kernel_sizes)
    return flops, 4 * (2 * B * T * C + weights)


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
            m = re.search(r"(residual_layer|mrf_pair|mrf_stage_streamed)((?:I(?:Li\d+E)+E)?)", line)
            if m and "entry function" in line:
                args = re.findall(r"Li(\d+)E", m.group(2))
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            elif kernel and ("registers" in line or "spill" in line):
                usage.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
        for kernel, lines in usage.items():
            log(f"  {kernel}: {'; '.join(lines)}")
        lib = cuda_build.library(name)
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.restype = ctypes.c_int
        if name == "denoiser_stack":
            smem.argtypes = [ctypes.c_int]
            log(f"  residual_layer shared memory per block: "
                f"{', '.join(f'C={c}: {smem(c)} B' for c in (128, 256))}")
        elif name == "mrf_stack_streamed":
            smem.argtypes = [ctypes.c_int] * 3
            log(f"  mrf_stage_streamed shared memory per block (the largest pass, "
                f"k=11 at dilation 5): {smem(256, 11, 5)} B")
        else:
            smem.argtypes = [ctypes.c_int] * 3
            for c in (32, 64, 128, 256):
                log(f"  mrf_pair<{c}, k> shared memory per block at dilation 5: "
                    f"{', '.join(f'k={k}: {smem(c, k, 5)} B' for k in (3, 7, 11))}")


def build_serving(torch, device):
    """The full LJSpeech shallow model and HiFi-GAN V1 on `device`, from
    seeds, through the entry points a user calls."""
    from mixgantts_tpu_torch.config import NormStats, get_configs_of
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    pre, cfg, _ = get_configs_of("LJSpeech")
    torch.manual_seed(0)
    model = MixGANTTS.from_configs(
        "shallow", pre, cfg,
        NormStats.default(pre["preprocessing"]["mel"]["n_mel_channels"]),
        device=device)
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
        for B, T in ((1, 256), (1, 1000), (4, 256), (4, 1000)):
            x = torch.randn(B, T, C, device=dev, generator=g)
            cond = torch.randn(B, T, Hc, device=dev, generator=g)
            step = torch.randn(B, C, device=dev, generator=g)
            got = den.fused_residual_stack(x, cond, step, stacked)
            want = den.fused_residual_stack_plain(x, cond, step, stacked)
            sync(torch)
            rec = records["fused_residual_stack"]
            for part, a, b in zip(("x", "skip"), got, want):
                rec["err"] = max(rec["err"], check_close(
                    f"fused_residual_stack B={B} T={T} {part}", a, b))

        gen = vocoder.generator
        rks = gen.resblock_kernel_sizes
        dils = gen.resblock_dilation_sizes[0]
        for stage, (C, T, call) in enumerate(mrf_calls(gen, rks, dils, T_mel=1000)):
            x = torch.randn(1, T, C, device=dev, generator=g)
            for name, st, ks, run in call:
                got = run(x)
                want = mrf.mrf_stack_plain(x, st, ks, dils)
                sync(torch)
                rec = records[name]
                rec["err"] = max(rec["err"], check_close(
                    f"{name} stage {stage} C={C} T={T} k={ks}", got, want))


def mrf_calls(gen, rks, dils, T_mel):
    """The MRF calls of one request at frame bucket T_mel, as
    `models.hifigan.fused_apply` makes them: per stage (C, T, [(kernel
    name, stacked weights, kernel sizes, fn(x [1, T, C]))])."""
    from mixgantts_tpu_torch.ops import mrf
    out, T, C = [], T_mel, gen.conv_pre.out_channels
    for stage, u in enumerate(gen.upsample_rates):
        T, C = T * u, C // 2
        if C <= 64:
            fold = 128 // C
            st = mrf.stack_mrf_params_folded(gen, stage, fold, rks, dils)
            call = [("mrf_stack_folded", st, rks,
                     lambda x, st=st, fold=fold: mrf.mrf_stack_folded(
                         x.reshape(x.shape[0], x.shape[1] // fold, -1), st, rks,
                         dils, prefolded=True))]
        elif C <= 128:
            st = mrf.stack_mrf_params(gen, stage, rks, dils)
            call = [("mrf_stack", st, rks,
                     lambda x, st=st: mrf.mrf_stack(x, st, rks, dils))]
        else:
            call = []
            for j, rk in enumerate(rks):
                st = mrf.stack_mrf_params(gen, stage, (rk,), dils, branches=[(j, rk)])
                call.append(("mrf_stack", st, (rk,),
                             lambda x, st=st, rk=rk: mrf.mrf_stack(x, st, (rk,), dils)))
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
            ms = time_ms(lambda: den.fused_residual_stack(x, cond, step, stacked), 20)
            plain = time_ms(lambda: den.fused_residual_stack_plain(x, cond, step, stacked), 20)
            b, by = bound_ms(*denoiser_work(B, T, C, Hc, L))
            log(f"  fused_residual_stack B={B} T={T}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
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
                flops, nbytes = mrf_work(1, T, C, ks)
                b, by = bound_ms(flops, nbytes)
                log(f"  {name} stage {stage} C={C} T={T} k={ks}: kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
                    f"{flops / ms / 1e9:.1f} TFLOP/s")
                rec = records[name]
                rec["ms"] += ms
                rec["plain_ms"] += plain
                rec["flops"] += flops
                rec["nbytes"] += nbytes
        for name in ("mrf_stack", "mrf_stack_folded"):
            rec = records[name]
            rec["bound_ms"], rec["bound_by"] = bound_ms(rec.pop("flops"), rec.pop("nbytes"))


def c256_stage(torch, vocoder, records):
    """Phase 7: the C=256 MRF stage (stage 0) of the vocoder in use, at the
    shapes of a B=1 request at frame bucket 1000 and a B=4 request at
    bucket 512, through the whole-stage kernel (`mrf_stack_streamed`; its
    launch count is read around this drive), held against the plain
    version, then timed beside the branchwise route that
    `models.hifigan.fused_apply` takes (three one-branch `mrf_stack` calls)
    and the plain version."""
    from mixgantts_tpu_torch.ops import mrf
    gen = vocoder.generator
    rks = gen.resblock_kernel_sizes
    dils = gen.resblock_dilation_sizes[0]
    C = gen.ups[0].out_channels
    whole = mrf.stack_mrf_params(gen, 0, rks, dils)
    branches = [(mrf.stack_mrf_params(gen, 0, (rk,), dils, branches=[(j, rk)]), rk)
                for j, rk in enumerate(rks)]
    g = torch.Generator("cuda").manual_seed(7)
    shapes = ((1, 1000 * gen.upsample_rates[0]), (4, 512 * gen.upsample_rates[0]))
    rec = records["mrf_stack_streamed"]
    with torch.no_grad():
        xs = [torch.randn(B, T, C, device="cuda", generator=g) for B, T in shapes]
        mrf.mrf_stack_streamed.launches = 0
        outs = [mrf.mrf_stack_streamed(x, whole, rks, dils) for x in xs]
        sync(torch)
        rec["launches"] = mrf.mrf_stack_streamed.launches
        log(f"[stage] mrf_stack_streamed launches during the C={C} stage drive: "
            f"{rec['launches']}")
        if rec["launches"] == 0:
            raise AssertionError("mrf_stack_streamed was not launched on the stage path")
        for (B, T), x, got in zip(shapes, xs, outs):
            rec["err"] = max(rec["err"], check_close(
                f"mrf_stack_streamed B={B} T={T} C={C}", got,
                mrf.mrf_stack_plain(x, whole, rks, dils)))

        def branchwise(x):
            return sum(mrf.mrf_stack(x, st, (rk,), dils) for st, rk in branches) / len(rks)

        faster = []
        for (B, T), x in zip(shapes, xs):
            # in turns: branchwise, streamed, streamed, branchwise
            bw1 = time_ms(lambda: branchwise(x), 10)
            st1 = time_ms(lambda: mrf.mrf_stack_streamed(x, whole, rks, dils), 10)
            st2 = time_ms(lambda: mrf.mrf_stack_streamed(x, whole, rks, dils), 10)
            bw2 = time_ms(lambda: branchwise(x), 10)
            ms, bw = (st1 + st2) / 2, (bw1 + bw2) / 2
            plain = time_ms(lambda: mrf.mrf_stack_plain(x, whole, rks, dils), 5)
            flops, nbytes = mrf_work(B, T, C, rks)
            b, by = bound_ms(flops, nbytes)
            share = mrf.streamed_flops(B, T, rks, dils) / flops
            log(f"  C={C} stage B={B} T={T} (tile {mrf.streamed_tile(B, T, x.device)}): "
                f"streamed {st1:.4f}/{st2:.4f} ms, branchwise {bw1:.4f}/{bw2:.4f} ms, "
                f"plain {plain:.4f} ms, bound {b:.4f} ms ({by}); streamed "
                f"{flops / ms / 1e9:.1f} TFLOP/s of needed work, recompute share {share:.3f}")
            faster.append(ms < bw)
            if B == 1:
                rec.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"[stage] streamed faster than branchwise at both shapes: {all(faster)}")


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
    import tempfile

    import numpy as np
    from scipy.io import wavfile
    from mixgantts_tpu_torch.cli.synthesize import cli
    from mixgantts_tpu_torch.frontend import preprocess_english
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    from mixgantts_tpu_torch.ops import mrf
    from mixgantts_tpu_torch.text import sequence_to_text
    counters = {"fused_residual_stack": den.fused_residual_stack,
                "mrf_stack": mrf.mrf_stack, "mrf_stack_folded": mrf.mrf_stack_folded}
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
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    from mixgantts_tpu_torch.ops import mrf
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    counters = {"fused_residual_stack": den.fused_residual_stack,
                "mrf_stack": mrf.mrf_stack, "mrf_stack_folded": mrf.mrf_stack_folded}
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


def cpu_reference(torch, pre, cfg, model, vocoder):
    """Phase 5: one small request on the GPU (kernels) and on the CPU
    (plain versions), same weights and injected noise."""
    import numpy as np
    from mixgantts_tpu_torch.config import NormStats
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    cpu_model = MixGANTTS.from_configs(
        "shallow", pre, cfg, NormStats.default(model.n_mels), device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_voc = get_vocoder(cfg, device="cpu")
    cpu_voc.generator.load_state_dict(vocoder.generator.state_dict())
    batch = text_batch(1, 8, 4, seed=2)
    T, M = 128, model.n_mels           # the frame bucket of 8 phone slots
    r = np.random.RandomState(3)
    noise = {"start_noise": r.randn(1, T, M).astype(np.float32),
             "step_noises": r.randn(model.diffusion.num_timesteps, 1, T, M).astype(np.float32)}
    outs = []
    for m, v in ((model, vocoder), (cpu_model, cpu_voc)):
        pipe = TTSPipeline(m, v, pre, cfg, mel_dtype=torch.float32)
        outs.append(pipe(batch, noise_override=noise))
    (gw, gm, gl), (cw, cm, cl) = outs
    if gm.shape != (1, T, M) or list(gl) != list(cl):
        raise AssertionError(f"GPU/CPU shapes or lengths differ: {gm.shape} {gl} {cl}")
    mae = float(np.abs(gm - cm).mean())
    lsb = int(np.abs(gw[0].astype(np.int32) - cw[0].astype(np.int32)).max())
    log(f"[reference] GPU vs CPU, mel_len {int(gl[0])}: mel mean|diff| {mae:.3e} "
        f"(max|mel| {float(np.abs(cm).max()):.3f}), int16 max|diff| {lsb} LSB "
        f"over {len(cw[0])} samples")
    if mae >= 1e-3 or lsb > 16:
        raise AssertionError("GPU path disagrees with the CPU reference")


def latency(torch, pipe, pre, one, four):
    """Phase 6b: request latency (host clock, ending in collect's copy to
    the host) and real-time factor = latency / audio seconds."""
    sr = pre["preprocessing"]["audio"]["sampling_rate"]
    for label, batch, reps in (("B=1 bucket 1000", one, 10), ("B=4 bucket 512", four, 10)):
        pipe(batch)
        times, audio = [], 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            wavs, _, _ = pipe(batch, return_mel=False)
            times.append(time.perf_counter() - t0)
            audio = sum(len(w) for w in wavs) / sr
        med = statistics.median(times)
        log(f"[latency] {label}: median {1e3 * med:.2f} ms (min {1e3 * min(times):.2f}, "
            f"max {1e3 * max(times):.2f}) over {reps}; audio {audio:.3f} s; RTF {med / audio:.5f}")


def profile_request(torch, pipe, one, out_dir):
    """One traced B=1 request: kernel time by name and the device's busy
    share of the wall time, from the chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    pipe(one)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(one, return_mel=False)
        wall = time.perf_counter() - t0
    path = os.path.join(out_dir, "request_trace.json")
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
    log(f"[profile] wall {1e3 * wall:.2f} ms, {len(kernels)} kernels, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / 1e6 / wall:.1f}% of wall), trace {path}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  {us / 1e3:9.3f} ms  {name[:110]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace one B=1 request into DIR")
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
    log("[stage] the C=256 MRF stage in one launch (TF32 off)")
    c256_stage(torch, vocoder, records)                           # phase 7
    log("[cli] raw text -> wav files through the synthesis CLI")
    cli_phase(torch, pre, cfg, model)                             # phase 8

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
