"""Smoke test and first measurement of the PyTorch/CUDA port on one NVIDIA
H100: shallow-mode LJSpeech and AISHELL3 text -> wav through
`mixgantts_tpu_torch`, in fp32 and bf16, with HiFi-GAN and MelGAN, a few
training steps in each mode (aux, naive, shallow) and each opt-in step
variant, the train CLI from aux through the aux -> shallow handoff to a
resumed shallow run, a raw corpus through prepare_align and preprocess
into the train CLI, and the multi-device path: data- and tensor-parallel
steps on two ranks, the train CLI under torchrun, sharded serving and the
multi-device dryrun; and the kernels at every width the JAX package's
configs give them (HiFi-GAN V2, the dryrun's tiny model, the denoiser up
to 2048 channels) and at every shape the TPU kernels take (the MRF kernels
up to 512 channels, every odd kernel size up to 11, every dilation
schedule within the 64-frame halo, HiFi-GAN V1 at 1024 channels).

    python3 chip_smoke.py                  # needs one CUDA device
    python3 chip_smoke.py --profile DIR    # keeps the request and train-step traces in DIR

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):
1. build the hand-written kernels (`mixgantts_tpu_torch/csrc/*.cu`, one nvcc
   per source, all started together) and print ptxas's registers, shared
   memory and spills per kernel; count the tensor-core instructions
   (`HGMMA`) in each kernel's SASS (`cuobjdump -sass`): every kernel (the
   denoiser's, the MRF's, the whole-stage MRF kernel's and the narrow
   stages' kernel's) must hold them and spill nothing; print the clusters
   each cluster kernel holds resident at once, the whole-stage kernel's
   plan at phase 7's shapes, and the narrow stages' kernel's plan at
   HiFi-GAN V2's C = 16 and 8 stages;
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
5. hold a small request served on the GPU (kernels, G) against the same
   request served on the CPU (plain versions, same weights, same injected
   noise): with the CPU's denoiser stack and MRF weights also in bf16 (B,
   the same arithmetic) and in fp32 (F), the same lengths, mel mean
   |G - B| <= 2 mean |B - F| and the waveform's max |G - B| <= 2 max |B - F|
   + 1 LSB of int16 (G and B round at the same points, so each is one
   rounding's distance from F, and the triangle inequality puts them at
   most twice that apart; each wave's own truncation to int16 adds at most
   1 LSB); against F, mel mean |diff| / max|mel| < 0.02 (the JAX package's
   bar for its bf16 denoiser, tests/test_pallas.py) and the waveform at an
   SNR above 30 dB (its bar for its bf16 vocoder, tests/test_vocoder.py).
   It prints each pair's distances, and B's mel vocoded on each side,
   which splits the wave's distance from the mel's.  (The absolute bars
   these replaced, mel mean |G - B| < 1e-3 and 16 LSB, are printed beside
   them: they held only for weights of torch's default scale, and the
   port's models now draw as the JAX package's);
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
   the CPU, the CPU's ReLUs passing what the GPU's passed (a ReLU input
   within rounding of 0 would pass its gradient on one device only):
   losses at rtol 1e-4, each gradient tensor within 1e-3 * max|g| on >= 99%
   of its elements and 1e-2 * max|g| on all, each ReLU input of differing
   sign within 1e-5 of its call's max|x|;
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
   memory, and the kernels' launches per mode and part;
14. the opt-in train-step variants at phase 12's width, batches and bucket
   (fp32 masters, TF32 off): `tpu.reuse_g_forward` naive (B=8) and
   shallow (B=4), `tpu.reuse_aux_forward` shallow (B=4), `tpu.compute_dtype:
   bfloat16` aux and naive (B=8) and shallow (B=4); a warm-up and three
   timed steps each (CUDA events): finite metrics, the mode's parameters
   moved (fp32 masters) and the others not, no kernel launched; ms per
   step, mel frames/s and peak memory beside phase 12's two-forward fp32
   step; one traced shallow step of each variant (device busy share,
   kernel launches); then on the GPU and on the CPU at B=2, T=128 (dropout
   off, the same injected noise) a `reuse_aux_forward` shallow step at
   phase 12's bars and a bf16 naive step at the CPU tests' bf16 bars (the
   losses through the updated D within rtol 5e-3, the others within 1e-4,
   each gradient tensor at cosine >= 0.999);
15. raw corpus -> preprocessing -> training on the card, in a temporary
   workspace with the shipped LJSpeech and AISHELL3 configs (only
   `val_size` changed: 8 and 4): synthetic raw corpora written here from a
   seed at 22.05 kHz (48 LJSpeech utterances of 2-5 s of harmonic tones;
   4 AISHELL3 speakers x 8) with the TextGrids an aligner would write,
   then `cli.prepare_align` and `cli.preprocess` for each (AISHELL3's
   DeepSpeaker on the card): every artifact present and finite, the split
   and the json files well formed, unit-norm embeddings, DeepSpeaker on
   the card against the CPU module on the same features and weights, the
   batched mel spectrogram on the card against the host one on 4 wavs
   (both max|diff| <= 1e-4 of the largest value, TF32 off); then the train
   CLI on the LJSpeech output, 8 aux steps, the handoff and 8 shallow steps
   with `reuse_aux_forward` and `compute_dtype: bfloat16`, one panel and
   one save a run: finite log lines, the checkpoint reloads, the shallow
   panel launches the denoiser and MRF kernels and no step any;
   utterances/s of preprocessing and its wall split by part (host clock),
   the train CLI's steps/s;
16. the multi-device path (`mixgantts_tpu_torch.parallel`), printing its
   topology (`K cards`, nccl or gloo) and wall time: (a) one
   data-parallel step per mode (naive B=8, shallow B=4, bucket 1000, full
   width, dropout on) on two ranks of this script (`--multi-worker`,
   started through `parallel.launch.start_ranks`), against the
   one-process step on the same batch, injected noise and dropout seed,
   the ranks' ReLUs passing what the one-process step's passed (each input
   of differing sign within 1e-5 of its call's max|x|, as phase 12): the
   metrics at rtol 1e-4, the parameters within Adam's sign-flip envelope;
   each rank's step time (median of 3 after the compared step,
   CUDA events, with nothing but the ranks on the card) and peak memory;
   (b) the same steps at tp2, with each rank's parameter and moment bytes
   against one GPU's, and one traced tp2 naive step on rank 0 (its
   collectives counted, the device's busy share of its wall); (c) the
   train CLI's `cli()` under `torchrun --nproc_per_node 2` (this script's
   `--train-cli-rank`) with `--data_parallel --tensor_parallel 2
   --profile_dir` for 2 shallow steps from a handoff checkpoint: a trace
   per rank, rank 0 alone launching the serving kernels for the panel and
   validation on the gathered weights, the first log line equal to a
   one-process run's (rtol 1e-3) and the rest in family (rtol 0.05), and
   `cli.evaluate` in one process on the run's checkpoint equal to its
   validation line (rtol 1e-3); (d) B=4 at bucket 512 through
   `TTSPipeline(mesh=[cuda:0, cuda:0])`: lengths equal, the mel at rtol
   1e-4 (atol 2e-2), int16 within 2 of the single replica's, every
   replica launching the serving kernels, latency beside one replica's;
   (e) `dryrun_multigpu(2, device="cuda")`, beside (c); (c) and (e) run
   while the ranks of (a) and (b) take their compared steps, and their
   timed steps follow with nothing else on the card; (f) with two or
   more cards, (a), (b) and (d) again over min(count, 4) cards and nccl;
17. the port's benchmark and measuring tools: (a) `python -m
   mixgantts_tpu_torch.bench` in a subprocess (its RTF line; a non-zero
   exit, a null value or a serving kernel launched no time fails); (b) one
   request at the bench's shapes (B=1, 64 phone slots, 24 words, the
   whole 864-frame mel vocoded, no bucket) on phase 4's weights, its
   kernel launches counted, against the CPU at phase 5's bars with the
   same injected noise; (c) `tests/bench_torch_serving.py` at B=1 (call)
   and B=8 (stream), `tests/bench_torch_step_parts.py` and
   `tests/bench_torch_denoiser_grad.py`, once each at 5 calls a round;
18. the denoiser kernel below C = 256 and the long-horizon drive's stages:
   (a) the kernel against its plain version (the bf16 tolerance) at every
   C in NARROW_WIDTHS (run at 64, 128 or 256 with zero channels above C),
   B in {1, 4}, T = 300, 20 layers, with and without a speaker term, its
   launch count rising at each call; its time at C = 16 and C = 64 (B=1,
   T=1000, 20 layers) beside the bound of each; (b) `tests/
   train_horizon_torch.py`'s stages at HORIZON_STEPS in a temporary
   workspace: its 24-utterance corpus through the preprocess CLI, aux 50
   steps, shallow 25 from the aux checkpoint and synthesis, each CLI in a
   subprocess on the card: every logged metric finite, a wav written (the
   drive's trend bars need its 1500 + 1000 steps and are not held here);
   (c) the synthesis CLI in process on that checkpoint (residual_channels
   16): the denoiser kernel and the MRF kernels must launch (counts set to
   0 just before, read just after); then the restored model and the CLI's
   random HiFi-GAN V1 on the same text against the CPU at phase 5's bars
   with injected noise, each MRF kernel against its plain version at the
   stages of that request's frame bucket, and the denoiser's stack there
   against its plain version, timed;
19. the kernels' widths: (a) the MRF kernels against their bf16 plain
   version at every C in MRF_WIDTHS (run at 8, 16, 32, 64, 128 or 256 with
   zero channels above C; the whole stage in one launch of
   `csrc/mrf_stage_narrow.cu` up to 16), B in {1, 4}: the whole
   three-branch stage up to 128 (the folded entry point where `fused_apply`
   takes it), one branch a call above, the launch count rising at each call
   by what the route launches; (b) HiFi-GAN V2 (V2_CONFIG, jik876/hifi-gan's
   config_v2.json: stages 64, 32, 16, 8) from a seed, through `get_vocoder`
   on a directory holding its config.json, vocoding phase 4's acoustic
   model: a B=1 request at bucket 1000 must launch the denoiser once, the
   folded entry point 20 times (the pair kernel 9 times at each of 64 and
   32, the narrow stages' kernel once at each of 16 and 8: `narrow_stage` 2)
   and `mrf_stack` none; a small request against the CPU at phase 5's bars;
   its latency beside V1's; each stage's MRF against its plain version and
   timed, the request's MRF time beside V1's and beside the bound of its
   work; (c) `dryrun_multigpu(2)` at the JAX dryrun's
   widths (denoiser 8, vocoder stages 8 and 4): rank 0's synthesis must
   launch the denoiser and the folded MRF kernel; (d) the denoiser kernel
   against its plain version at C in WIDE_WIDTHS (run at 512 in clusters of
   16 CTAs up to 512, above on the wide route, two launches a layer), as
   phase 18 (a), its resident clusters, and its time at C = 512 and
   WIDE_TIMED (B=1, T=1000, 20 layers) beside the bound; (e) phase 4's
   acoustic model with the denoiser at WIDE_MODEL_CHANNELS channels from a
   seed: a B=1 request at bucket 1000 must launch the denoiser 40 times and
   the MRF kernels 18 and 18, a small request against the CPU at phase 5's
   bars, its latency;
20. the MRF kernels at every shape the TPU kernels take: (a) each against
   its bf16 plain version at B=1, T=8000 and B=4, T=4096 (SHAPE_FRAMES, the
   frames of a 512-wide stage at buckets 1000 and 512), its launch count
   rising by what the call launches: `mrf_stack` at C in WIDE_MRF_WIDTHS
   (run at 512, two launches a pair), one branch a call; `mrf_stack` at
   MRF_SHAPES (k in {1, 5, 9}, schedules at the halo's edge, the widest
   conv1 reach) at MRF_SHAPE_WIDTHS; the folded entry point at those
   shapes (C = 64 on the pair kernel, C = 16 on the narrow stages' kernel,
   one launch); `mrf_stack_streamed` at STREAMED_WIDTHS (run at
   256 and 512, clusters of 4 and 8) and STREAMED_SHAPES, up to the widest
   conv1 reach; and the whole-stage kernel's plan at each; (b) HiFi-GAN V1 at
   `upsample_initial_channel` 1024 (V1_1024_CONFIG: stages 512, 256, 128,
   64) from a seed through `get_vocoder`, vocoding phase 4's acoustic
   model: a B=1 request at bucket 1000 must launch the denoiser once,
   `mrf_stack` 36 times and the folded kernel 9; a small request against
   the CPU at phase 5's bars; its latency; each MRF call of the request
   against its plain version and timed, beside the bound of the request's
   MRF work; (c) the time of each new shape at B=1, T=8000 beside its
   bound: the 512 stage through `mrf_stack` (three one-branch calls) and
   through `mrf_stack_streamed`, MRF_SHAPES at C = 256 and STREAMED_SHAPES
   at 512.

The line before the last is {"kernels": [...]} (per kernel: launches in
phase 4 plus phase 16's replicas and train CLI ranks and phase 17's and
phase 18 (c)'s requests, or phase 7 for `mrf_stack_streamed`, or phase
18 (c) for the denoiser at C = 16, or phase 19 (b)'s request for V2's
folded MRF on the pair kernel (`mrf_stack_folded_v2`: C = 64 and 32) and on
the narrow stages' kernel (`mrf_stage_narrow`: C = 16 and 8), or phase 19
(d)'s checks for the denoiser at C = 512, or
phase 19 (e)'s request for the denoiser above 512, or
phase 20 (b)'s request for `mrf_stack_c512` (every `mrf_stack` launch of
the 1024 vocoder's request), or phase 20 (a)'s checks for
`mrf_stack_shapes` and `mrf_stack_streamed_c512`; max error in phase 3, 7,
18, 19 or 20; and the time, plain time and bound of one B=1 request at
frame bucket 1000, or of phase 18 (c)'s stack, or of V2's MRF calls of
each kernel in one request at bucket 1000, or of the C = 512 and C = 1024
stacks at B=1,
T=1000, or of the
512-wide MRF stage at B=1, T=8000 (`mrf_stack_c512`,
`mrf_stack_streamed_c512`), or of k = (1, 5, 9) at C = 256, B=1, T=8000
(`mrf_stack_shapes`)); the last line is {"ok": true, "device": {...}}.
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
KERNELS = ("residual_stack_mma", "wide_conv_gate", "wide_out_proj", "mrf_pair_mma",
           "mrf_wide_mma", "mrf_stage_streamed", "mrf_stage_narrow")   # __global__ names
STAGE_SHAPES = ((1, 8000), (4, 4096))   # V1's C=256 stage in a B=1 request at bucket 1000, B=4 at 512
N_SPEAKERS = 218            # AISHELL3's speakers
DEVICE = "cuda"             # the card every phase runs on
# kernel launches of one request of the main path's shapes (B, frame bucket):
# (denoiser, mrf_stack, mrf_stack_folded), as phase 4's requests launch them
REQUEST_LAUNCHES = {(1, 1000): (1, 18, 18), (4, 512): (2, 18, 18)}
NARROW_WIDTHS = (16, 32, 48, 64, 80, 192, 256)   # phase 18 (a): the denoiser kernel's widths
HORIZON_STEPS = (50, 25)    # phase 18 (b): aux steps, then shallow steps from the aux checkpoint
MRF_WIDTHS = (4, 8, 16, 24, 48, 72, 96, 144, 200)   # phase 19 (a): the MRF kernels' widths
V2_LAUNCHES = (1, 0, 20)   # phase 19 (b): a V2 request's (denoiser, mrf_stack, mrf_stack_folded)
V2_NARROW = ((16, 128000), (8, 256000))   # V2's stages on the narrow kernel at bucket 1000
WIDE_WIDTHS = (288, 384, 512, 544, 768, 1024, 2048)  # phase 19 (d): the denoiser above 256
WIDE_TIMED = (768, 1024, 2048)   # phase 19 (d): the wide route's widths timed at B=1, T=1000
WIDE_MODEL_CHANNELS = 1024       # phase 19 (e): the acoustic model's residual_channels
# phase 19 (b): HiFi-GAN V2, the public config_v2.json of jik876/hifi-gan
V2_CONFIG = {"resblock": "1", "num_mels": 80, "upsample_rates": [8, 8, 2, 2],
             "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 128,
             "resblock_kernel_sizes": [3, 7, 11],
             "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]]}
# phase 20: HiFi-GAN V1 (config_v1.json) at upsample_initial_channel 1024,
# whose first stage is 512 wide; the shapes at which (a) holds the MRF
# kernels, (B, T): that stage's frames at buckets 1000 and 512
V1_1024_CONFIG = dict(V2_CONFIG, upsample_initial_channel=1024)
SHAPE_FRAMES = ((1, 8000), (4, 4096))
WIDE_MRF_WIDTHS = (288, 384, 512)   # mrf_stack above 256 (run at 512)
# the TPU kernels' shapes beyond V1's, (kernel sizes, dilations): k in
# {1, 5, 9} with V1's schedule, two schedules at the halo's edge (creeps 36
# and 60) and the widest conv1 reach (63 frames)
MRF_SHAPES = (((1, 5, 9), (1, 3, 5)), ((3,), (1, 2, 4, 8, 16)), ((11,), (2, 3, 4)),
              ((3,), (63,)))
MRF_SHAPE_WIDTHS = (32, 128, 256, 512)
STREAMED_WIDTHS = (144, 256, 288, 512)   # the whole-stage kernel (run at 256 and 512)
# the whole-stage kernel's shapes: V1's, k in {1, 5, 9}, a halo edge, six
# branches, then the widest conv1 reaches (63, 62 and 55 frames, and 62 over
# two branches), whose plans at 512 run y out of place
STREAMED_SHAPES = (((3, 7, 11), (1, 3, 5)), ((1, 5, 9), (1, 3, 5)), ((3,), (1, 2, 4, 8, 16)),
                   ((1, 3, 5, 7, 9, 11), (1, 2)), ((3,), (63,)), ((5,), (31,)), ((11,), (11,)),
                   ((5, 3), (31,)))


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
            m = re.search(r"(%s)((?:I(?:L[ib]\d+E)+E)?)" % "|".join(KERNELS), line)
            if m and "entry function" in line:
                args = re.findall(r"L[ib](\d+)E", m.group(2))
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
        if name == "mrf_stage_narrow":
            from mixgantts_tpu_torch.ops import mrf
            for C, T in V2_NARROW + ((16, 65536), (8, 131072)):   # B=1 at 1000, B=4 at 512
                B = 1 if T in (128000, 256000) else 4
                plan = mrf.narrow_plan(B, T, C=C)
                log(f"  mrf_stage_narrow<{C}> at B={B} T={T}: tile {plan['tile']} frames "
                    f"(halo {plan['lead']} a side), {plan['blocks']} blocks, {plan['resident']} "
                    f"resident at once, passes of {plan['rows']} rows, {plan['smem']} B of "
                    f"shared memory per block")
            for C in mrf.NARROW_WIDTHS:
                for ks, ds in (((3, 7, 11), (1, 3, 5)), ((3,), (63,)), ((11,), (2, 3, 4))):
                    smem, tile = mrf.narrow_smem_bytes(C, ks, ds)
                    log(f"  mrf_stage_narrow<{C}> k={ks} d={ds}: at most {tile} frames a "
                        f"block, {smem} B of shared memory")
            continue
        if name == "mrf_stack_streamed":
            from mixgantts_tpu_torch.ops import mrf
            for C in mrf.STREAMED_WIDTHS:
                for B, T in STAGE_SHAPES:
                    plan = mrf.streamed_plan(B, T, C=C)
                    log(f"  mrf_stage_streamed<{C}> at B={B} T={T}: clusters of "
                        f"{plan['cluster']} CTAs, {plan['resident']} clusters resident at "
                        f"once, tile {plan['tile']} frames, passes of {plan['rows']} rows, "
                        f"{plan['smem']} B of shared memory per CTA, y in a slab of "
                        f"{4 * plan['slab'] / 1e6:.1f} MB")
            continue
        lib = cuda_build.library(name)
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.restype = ctypes.c_int
        if name == "denoiser_stack":
            from mixgantts_tpu_torch.ops import denoiser_stack as den
            smem.argtypes = [ctypes.c_int]
            for c in den.KERNEL_WIDTHS:
                ctas, cluster, resident = den.launch_shape(1, 1000, c)
                log(f"  residual_stack_mma<{c}>: {smem(c)} B of shared memory per CTA, "
                    f"clusters of {cluster} CTAs, {resident} clusters resident at once; "
                    f"{ctas} CTAs per launch at B=1, T=1000")
            c = WIDE_MODEL_CHANNELS
            ctas, _, resident = den.launch_shape(1, 1000, c)
            log(f"  wide_conv_gate (C > 512): {smem(c)} B of shared memory per CTA, {resident} "
                f"CTAs resident at once; {ctas} CTAs per launch at B=1, T=1000, C={c}, two "
                f"launches a layer")
        else:
            from mixgantts_tpu_torch.ops import mrf
            smem.argtypes = [ctypes.c_int] * 3
            for c in mrf.PAIR_WIDTHS:
                kernel = "mrf_wide_mma" if c > mrf.SPLIT else "mrf_pair_mma"
                log(f"  {kernel}<{c}, k> shared memory per block at dilation 5 (and at the "
                    f"widest reach, k = 3 and d = 63), and output frames per block: " + ", ".join(
                        f"k={k}: {smem(c, k, 5)} B, {mrf.tile_frames(c, k)}"
                        for k in range(1, 12, 2)) + f"; {smem(c, 3, 63)} B")


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
            k = re.search(r"(%s)((?:I(?:L[ib]\d+E)+E)?)" % "|".join(KERNELS), m.group(1))
            args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
            fn = (k.group(1) + (f"<{', '.join(args)}>" if args else "")) if k else m.group(1)
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def build_serving(torch, device, dataset="LJSpeech"):
    """The full shallow model of a dataset's configs (AISHELL3: N_SPEAKERS
    speakers, DeepSpeaker embeddings) and its HiFi-GAN V1 on `device`, from
    seeds, through the entry points a user calls."""
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    pre, cfg, _ = get_configs_of(dataset)
    model = build_acoustic(torch, pre, cfg, device)
    vocoder = get_vocoder(cfg, device=device, seed=0)
    return pre, cfg, model, vocoder


def build_acoustic(torch, pre, cfg, device):
    """The shallow acoustic model of the configs on `device`, random weights
    from seed 0."""
    from mixgantts_tpu_torch.config import NormStats
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
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
    return model


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


def cpu_copy(torch, pre, cfg, model, vocoder, ckpt_dir=None):
    """The serving model and vocoder (`get_vocoder` on `ckpt_dir`) with the
    same weights on the CPU."""
    from mixgantts_tpu_torch.config import NormStats
    from mixgantts_tpu_torch.models.mixgantts import MixGANTTS
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    cpu_model = MixGANTTS.from_configs(
        "shallow", pre, cfg, NormStats.default(model.n_mels),
        n_speakers=N_SPEAKERS if cfg["multi_speaker"] else 1, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_voc = get_vocoder(cfg, ckpt_dir=ckpt_dir, device="cpu")
    cpu_voc.generator.load_state_dict(vocoder.generator.state_dict())
    return cpu_model, cpu_voc


def on_gpu_and_cpu(torch, model, vocoder, cpu_model, cpu_voc, serve):
    """serve(model, vocoder) on the GPU (kernels), then on the CPU with its
    denoiser stack and MRF weights in bf16 (the GPU's arithmetic), then in
    fp32: three (int16 waves, mel, lengths)."""
    outs = []
    for m, v, dtype in ((model, vocoder, None), (cpu_model, cpu_voc, torch.bfloat16),
                        (cpu_model, cpu_voc, torch.float32)):
        v.generator.mrf_dtype = dtype
        m.diffusion.denoise_fn.stack_dtype = dtype
        outs.append(serve(m, v))
    cpu_voc.generator.mrf_dtype = None
    cpu_model.diffusion.denoise_fn.stack_dtype = None
    return outs


def vocoded_on_both(torch, vocoder, cpu_voc, served, hop=256):
    """The mel of `served` (int16 waves, mel [1, T, M], lengths) through
    the GPU's vocoder (kernels) and the CPU's with its MRF weights in bf16
    and in fp32, each as `TTSPipeline` makes its int16 wave: {"gpu",
    "bf16", "fp32": wave}.  Vocoding one mel on both sides splits the
    wave's distance from the mel's."""
    import numpy as np
    _, mel, lens = served
    out = {}
    for name, v, dtype in (("gpu", vocoder, None), ("bf16", cpu_voc, torch.bfloat16),
                           ("fp32", cpu_voc, torch.float32)):
        v.generator.mrf_dtype = dtype
        dev = next(v.generator.parameters()).device
        with torch.no_grad():
            wav = v(torch.as_tensor(mel, device=dev))
            wav = torch.clamp(wav * 32768.0, -32768.0, 32767.0).to(torch.int16).cpu().numpy()
        out[name] = np.asarray(wav[0, :int(lens[0]) * hop])
    cpu_voc.generator.mrf_dtype = None
    return out


def cpu_reference(torch, pre, cfg, model, vocoder, label="reference", ckpt_dir=None):
    """Phase 5 (and 9): one small request on the GPU (kernels) and on the
    CPU (plain versions), same weights and injected noise (and, for a
    multi-speaker model, speaker embedding): the CPU once with its denoiser
    stack and MRF weights in bf16 (the GPU's arithmetic), once in fp32."""
    import numpy as np
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    cpu_model, cpu_voc = cpu_copy(torch, pre, cfg, model, vocoder, ckpt_dir)
    batch = with_speakers(text_batch(1, 8, 4, seed=2), cfg, seed=2)
    T, M = 128, model.n_mels           # the frame bucket of 8 phone slots
    r = np.random.RandomState(3)
    noise = {"start_noise": r.randn(1, T, M).astype(np.float32),
             "step_noises": r.randn(model.diffusion.num_timesteps, 1, T, M).astype(np.float32)}
    outs = on_gpu_and_cpu(torch, model, vocoder, cpu_model, cpu_voc, lambda m, v: TTSPipeline(
        m, v, pre, cfg, mel_dtype=torch.float32)(batch, noise_override=noise))
    check_against_cpu(label, T, M, *outs, vocoded_on_both(torch, vocoder, cpu_voc, outs[1]))


def distances(a, b):
    """(max |a - b|, rms(a - b), mean |a - b|) of two arrays, in float64."""
    import numpy as np
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.abs(d).max()), float(np.sqrt((d ** 2).mean())), float(np.abs(d).mean())


def check_against_cpu(label, T, M, gpu, bf16, fp32, split):
    """Phase 5's bars on (int16 waves, mel, lengths) served on the GPU (G)
    and on the CPU in bf16 (B, the GPU's arithmetic) and in fp32 (F), with
    the same lengths:
    - the same arithmetic: mean|G - B| of the mel <= 2 mean|B - F|, and
      max|G - B| of the wave <= 2 max|B - F| + 1 LSB.  G and B round at the
      same points, so each is as far from F as the other is, and the
      triangle inequality puts them at most twice that apart (sqrt 2 where
      their roundings are independent); each wave is truncated to int16 on
      its own, which adds at most 1 LSB to the difference;
    - the JAX package's relative bars against fp32: mel mean|G - F| /
      max|F| < 0.02 (its bar for its bf16 denoiser, tests/test_pallas.py)
      and the wave at an SNR above 30 dB (its bar for its bf16 vocoder,
      tests/test_vocoder.py).
    Prints each pair's distances, and the CPU bf16 path's mel vocoded on
    each side (`split`), which separates the wave's distance from the
    mel's; and, beside the new bars, the absolute ones they replaced (mel
    mean|G - B| < 1e-3, wave within 16 LSB), which hold only for weights of
    torch's default scale."""
    import numpy as np
    (gw, gm, gl), (bw, bm, bl), (fw, fm, fl) = gpu, bf16, fp32
    if gm.shape != (1, T, M) or not list(gl) == list(bl) == list(fl):
        raise AssertionError(f"GPU/CPU shapes or lengths differ: {gm.shape} {gl} {bl} {fl}")
    g, b, f = (w[0].astype(np.float64) for w in (gw, bw, fw))
    mae, mae_twin = float(np.abs(gm - bm).mean()), float(np.abs(bm - fm).mean())
    lsb, lsb_twin = int(np.abs(g - b).max()), int(np.abs(b - f).max())
    mel_rel = float(np.abs(gm - fm).mean() / np.abs(fm).max())
    snr = 10 * math.log10((f ** 2).mean() / max(((f - g) ** 2).mean(), 1e-12))
    log(f"[{label}] GPU vs CPU, mel_len {int(gl[0])}, max|mel| {float(np.abs(fm).max()):.3f}, "
        f"{len(f)} samples, wave rms {math.sqrt((f ** 2).mean()):.1f}: the same arithmetic: "
        f"mel mean|G - B| {mae:.3e} against the bar 2 x mean|B - F| = {2 * mae_twin:.3e} "
        f"(old bar 1e-3), wave max|G - B| {lsb} LSB against 2 x {lsb_twin} + 1 = "
        f"{2 * lsb_twin + 1} (old bar 16); against fp32: mel mean|G - F| / max|F| "
        f"{mel_rel:.3e} (bar 0.02), SNR {snr:.1f} dB (bar 30)")
    for what, pairs in (("mel", (("G-B", gm, bm), ("B-F", bm, fm), ("G-F", gm, fm))),
                        ("wave", (("G-B", g, b), ("B-F", b, f), ("G-F", g, f))),
                        ("wave of B's mel", (("G-B", split["gpu"], split["bf16"]),
                                             ("B-F", split["bf16"], split["fp32"]),
                                             ("G-F", split["gpu"], split["fp32"])))):
        log(f"  [{label}] {what}: " + "; ".join(
            "{} max {:.4g}, rms {:.4g}, mean {:.4g}".format(name, *distances(x, y))
            for name, x, y in pairs))
    if mae > 2 * mae_twin or lsb > 2 * lsb_twin + 1 or mel_rel >= 0.02 or snr <= 30:
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
    return trace(torch, lambda: pipe(batch, return_mel=False), path, tag, top).by_name


def read_trace(path):
    """(every event, {kernel name: device us}, the device's busy us: the
    union of the kernels' spans) of the chrome trace at `path`."""
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
    return events, by_name, busy


def trace(torch, fn, path, tag, top=15):
    """One traced call of fn: kernel time by name and the device's busy
    share of the wall time (the union of kernel spans), from the chrome
    trace at `path`.  Returns a namespace of by_name ({kernel name: device
    us}), kernels (launches), busy_ms, wall_ms and events."""
    import types
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    events, by_name, busy = read_trace(path)
    kernels = sum(1 for e in events if e.get("cat") == "kernel" and "dur" in e)
    log(f"[{tag}] wall {1e3 * wall:.2f} ms, {kernels} kernels, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / 1e6 / wall:.1f}% of wall), trace {path}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us / 1e3:9.3f} ms  {name[:110]}")
    return types.SimpleNamespace(by_name=by_name, kernels=kernels, busy_ms=busy / 1e3,
                                 wall_ms=1e3 * wall, events=events)


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


def timed_steps(torch, mode, model, disc, state, step_fn, batch, counters):
    """A warm-up step and TRAIN_STEPS timed ones (CUDA events, and the host
    clock around each step's finite-metrics check), the kernel counters set
    to 0 just before.  Returns a namespace of the step times, the last
    metrics, the launches, peak and base memory, the parameters the mode
    trains (`named`, D's too outside aux) and their values before."""
    import types
    from mixgantts_tpu_torch.train import check_finite_metrics
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
    return types.SimpleNamespace(
        times=times, wall=wall, warm=warm, median=statistics.median(times), metrics=metrics,
        launches={name: c.launches for name, c in counters.items()},
        peak=torch.cuda.max_memory_allocated(), base=base,
        frames=int(batch["mel_lens"].sum()), named=named, before=before)


def check_trained(torch, label, mode, run):
    """No kernel launched in `timed_steps`' run; every parameter the mode
    trains moved and stayed an fp32 master, and those it freezes did not
    move."""
    import re
    if any(run.launches.values()):
        raise AssertionError(f"{label} training launched a serving kernel: {run.launches}")
    frozen, still, moved_frozen = TRAIN_FROZEN[mode], [], []
    for (name, p), p0 in zip(run.named, run.before):
        if p.dtype != torch.float32:
            raise AssertionError(f"{label}: {name} is {p.dtype}, not an fp32 master")
        moved = not torch.equal(p.detach(), p0)
        if frozen and re.search(frozen, name.split(" ", 1)[1]):
            if moved:
                moved_frozen.append(name)
        elif not moved and not re.search(TRAIN_MAY_STAY, name):
            still.append(name)
    if still or moved_frozen:
        raise AssertionError(f"{label}: trained parameters that did not move {still[:8]}, "
                             f"frozen ones that moved {moved_frozen[:8]}")


def training_phase(torch, out_dir):
    """Phase 12: aux (B = batch_size), naive (batch_size) and shallow
    (batch_size_shallow) training at the full width of the LJSpeech
    configs, on synthetic batches at phone bucket 128, word bucket 64, mel
    bucket 1000 (lengths 600-1000): one warm-up step, then TRAIN_STEPS
    timed ones (CUDA events).  The metrics must be finite, every parameter
    the mode trains must move (D's too in naive and shallow) and the
    others not, and no kernel may launch during the steps.  Median ms per
    step, peak memory, and one traced shallow step with its device busy
    share; then one shallow and one naive step against the CPU.  Returns
    {mode: (median ms per step, mel frames/s, peak GiB)}."""
    from mixgantts_tpu_torch.config import get_configs_of
    pre, cfg, tc = get_configs_of("LJSpeech")
    counters = all_kernel_counters()
    results = {}
    for mode in ("aux", "naive", "shallow"):
        B = tc["optimizer"]["batch_size_shallow" if mode == "shallow" else "batch_size"]
        model, disc, state, step_fn = build_training(torch, mode, pre, cfg, tc)
        batch = train_batch(torch, pre, B, 128, 64, 1000, (600, 1000), seed=12)
        run = timed_steps(torch, mode, model, disc, state, step_fn, batch, counters)
        frames, med, peak, base = run.frames, run.median, run.peak, run.base
        log(f"[train] {mode} B={B} bucket 1000 ({frames} frames): "
            f"{statistics.median(run.wall):.2f} ms per step on the host clock, device "
            f"{med:.2f} ms (CUDA events; {', '.join(f'{x:.2f}' for x in run.times)}), "
            f"{1e3 * frames / med:.0f} mel frames/s; warm-up step {1e3 * run.warm:.0f} ms; "
            f"peak memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB over the "
            f"{base / 2**30:.2f} GiB allocated before the steps; "
            + ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(run.metrics.items())))
        check_trained(torch, mode, mode, run)
        log(f"  {len(run.named)} parameter tensors, none of the serving kernels launched "
            f"({run.launches})")
        if mode == "shallow":
            trace(torch, lambda: step_fn(state, batch),
                  os.path.join(out_dir, "shallow_train_step_trace.json"), "train trace")
        results[mode] = (med, 1e3 * frames / med, peak / 2**30)
        del model, disc, state, step_fn, batch, run
        torch.cuda.empty_cache()
    train_cpu_reference(torch, pre, cfg, tc)
    return results


def train_cpu_reference(torch, pre, cfg, tc):
    """Phase 12b: one shallow and one naive step at B=2, T=128 on the
    full-width model (a non-zero denoiser output projection, so the
    residual stack's gradients show), TF32 off, dropout p = 0, the same
    injected t and noise, on the GPU and on the CPU from the same weights,
    the CPU's ReLUs passing what the GPU's passed (`SharedReluKinks`: a ReLU
    input within rounding of 0 passes its gradient on one device only,
    which moves every tensor upstream of it; the inputs of differing sign
    must be within 1e-5 of their call's max|x|): every loss at rtol 1e-4;
    every gradient tensor of G and D within 1e-3 * max|g| on >= 99% of its
    elements and within 1e-2 * max|g| on all, max|g| floored at 1e-3 of
    the model's largest gradient (the K-projection and PostNet conv biases
    have a zero gradient by symmetry, softmax's shift invariance and
    BatchNorm's mean, so theirs is rounding noise on both devices)."""
    for mode in ("shallow", "naive"):
        check_gpu_against_cpu(mode, *step_on_gpu_and_cpu(torch, mode, pre, cfg, tc))


class SharedReluKinks:
    """`torch.nn.functional.relu` for one step (the GPU's, or one process's),
    then the same step elsewhere (on the CPU, or sharded over ranks), whose
    calls come in the same order: the first records, call by call, which
    inputs are positive; the second passes exactly those (`local(mask, x)`
    cutting a rank's part of each).  A ReLU input within rounding of 0
    would otherwise pass its gradient in one step only, and that one
    element reaches every tensor upstream of it
    (`tests/train_step_kinks_torch.py`).  `flips` gets, per replayed call
    whose signs differ from the recorded ones, (call, inputs of differing
    sign, the largest |x| among them / max|x| of the call)."""

    def __init__(self, torch, masks=None):
        import torch.nn.functional as F
        self.torch, self.F, self.relu = torch, F, F.relu
        self.masks, self.flips = masks if masks is not None else [], []

    def recording(self):
        def recording(x, inplace=False):
            self.masks.append(x.detach() > 0)
            return self.relu(x, inplace)
        return self._patched(recording)

    def replaying(self, local=lambda mask, x: mask):
        calls = iter(range(len(self.masks)))

        def replaying(x, inplace=False):
            i = next(calls)
            mask = local(self.masks[i], x).to(x.device)
            differ = mask != (x.detach() > 0)
            if differ.any():
                top = float(x.detach().abs().max())
                self.flips.append((i, int(differ.sum()),
                                   float(x.detach().abs()[differ].max()) / max(top, 1e-30)))
            return self.torch.where(mask, x, self.torch.zeros_like(x))
        return self._patched(replaying)

    def _patched(self, fn):
        import contextlib

        @contextlib.contextmanager
        def patched():
            self.F.relu = fn
            try:
                yield
            finally:
                self.F.relu = self.relu
        return patched()


def step_on_gpu_and_cpu(torch, mode, pre, cfg, tc, n_noise=2):
    """One step of `mode` with model.yaml `cfg` at B=2, T=128 on the
    full-width model (a non-zero denoiser output projection), dropout
    p = 0 and the same injected t and noise (`n_noise` diffusion branches),
    on the GPU and on the CPU from the same weights, the CPU's ReLUs taking
    the GPU's decisions (`SharedReluKinks`).  Returns ((GPU losses,
    gradients), (CPU losses, gradients), the ReLU inputs whose sign
    differed), the gradients on the CPU by "G name" / "D name"."""
    import numpy as np
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
             for _ in range(n_noise)]
    init = [{k: v.clone() for k, v in m.state_dict().items()} for m in (gpu_model, gpu_disc)]
    runs = []
    kinks = SharedReluKinks(torch)
    for (model, disc, state, step_fn), batch, device in zip(built, batches, devices):
        model.load_state_dict(init[0])
        disc.load_state_dict(init[1])
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        with kinks.replaying() if runs else kinks.recording():
            metrics = step_fn(state, batch, noise_overrides=[
                {k: torch.as_tensor(v, device=device) for k, v in n.items()} for n in noise])
        grads = {f"{tag} {n}": (p.grad.detach().cpu() if p.grad is not None
                                 else torch.zeros(p.shape))
                 for tag, m in (("G", model), ("D", disc)) for n, p in m.named_parameters()}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads))
    return runs + [kinks.flips]


def check_gpu_against_cpu(mode, gpu, cpu, flips, label="train cpu"):
    """Phase 12's bars on `step_on_gpu_and_cpu`'s runs; and every ReLU input
    whose sign differed between the devices within 1e-5 of max|x| of its
    call (within rounding of 0: each fp32 operation moves a value by at
    most 2^-24 of the magnitudes it combines, and the deepest ReLU input of
    a step is ~100 of them from the step's inputs, so the devices' values
    differ by ~6e-6 of the call's scale)."""
    (gm, gg), (cm, cg) = gpu, cpu
    far = [f for f in flips if f[2] > 1e-5]
    log(f"[{label}] {mode}: ReLU inputs of differing sign on the two devices (the CPU took "
        f"the GPU's): {sum(f[1] for f in flips)} in {len(flips)} calls, the largest "
        f"{max([f[2] for f in flips], default=0.0):.2e} of its call's max|x| (bar 1e-5)")
    if far:
        raise AssertionError(f"{mode}: ReLU inputs of differing sign beyond rounding: {far[:6]}")
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
    log(f"[{label}] {mode} B=2 T=128, GPU against CPU: losses "
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


# Phase 14's bf16 bars, tests/test_torch_train_variants.py's: the losses
# that read the D which phase 1 updated (Adam's sign-like first step turns
# bf16 rounding flips of D's near-zero gradients into whole steps), and
# each gradient tensor's cosine; the other losses at phase 12's rtol 1e-4.
BF16_UPDATED_D_RTOL, BF16_GRAD_COSINE = 5e-3, 0.999
UPDATED_D_KEYS = ("adv_loss", "fm_loss", "G_loss", "total_loss")

# Phase 14: the opt-in step variants, (model.yaml tpu key, value, mode).
TRAIN_VARIANTS = (("reuse_g_forward", True, "naive"), ("reuse_g_forward", True, "shallow"),
                  ("reuse_aux_forward", True, "shallow"), ("compute_dtype", "bfloat16", "aux"),
                  ("compute_dtype", "bfloat16", "naive"),
                  ("compute_dtype", "bfloat16", "shallow"))


def variant_config(cfg, **tpu):
    import copy
    out = copy.deepcopy(cfg)
    out["tpu"] = dict(out.get("tpu") or {}, **tpu)
    return out


def train_variants_phase(torch, out_dir, plain):
    """Phase 14: the opt-in step variants at phase 12's full width, batches
    and bucket (fp32 masters, TF32 off, random weights from seed 0):
    `reuse_g_forward` naive (B=8) and shallow (B=4), `reuse_aux_forward`
    shallow (B=4), `compute_dtype: bfloat16` aux and naive (B=8) and
    shallow (B=4); a warm-up step and three timed ones (CUDA events).  The
    metrics must be finite, every parameter the mode trains must move and
    the others not, and none of the four kernels may launch.  Prints ms
    per step, mel frames/s and peak memory beside phase 12's two-forward
    fp32 step of the same mode (`plain`), and one traced shallow step of
    each variant (device busy share, kernel launches).  Then, on the GPU
    and on the CPU at B=2, T=128 (dropout off, the same injected noise): a
    `reuse_aux_forward` shallow step at phase 12's bars, and a bf16 naive
    step at the CPU tests' bf16 bars (the losses through the updated D
    within rtol 5e-3, the others within phase 12's 1e-4; each gradient
    tensor at cosine >= 0.999 with the CPU's, tensors with a norm below
    1e-3 of the largest left out)."""
    from mixgantts_tpu_torch.config import get_configs_of
    pre, cfg, tc = get_configs_of("LJSpeech")
    counters = all_kernel_counters()
    for key, value, mode in TRAIN_VARIANTS:
        label = f"{key}={value} {mode}"
        B = tc["optimizer"]["batch_size_shallow" if mode == "shallow" else "batch_size"]
        model, disc, state, step_fn = build_training(
            torch, mode, pre, variant_config(cfg, **{key: value}), tc)
        batch = train_batch(torch, pre, B, 128, 64, 1000, (600, 1000), seed=12)
        run = timed_steps(torch, mode, model, disc, state, step_fn, batch, counters)
        med, peak = run.median, run.peak / 2**30
        p_ms, p_fps, p_peak = plain[mode]
        log(f"[train variants] {label} B={B}: {med:.2f} ms per step (CUDA events; "
            f"{', '.join(f'{x:.2f}' for x in run.times)}), {1e3 * run.frames / med:.0f} mel "
            f"frames/s, peak memory {peak:.2f} GiB; the two-forward fp32 step (phase 12): "
            f"{p_ms:.2f} ms, {p_fps:.0f} mel frames/s, {p_peak:.2f} GiB; "
            + ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(run.metrics.items())))
        check_trained(torch, label, mode, run)
        if mode == "shallow":
            trace(torch, lambda: step_fn(state, batch),
                  os.path.join(out_dir, f"shallow_{key}_step_trace.json"),
                  f"train variants trace {label}", top=6)
        del model, disc, state, step_fn, batch, run
        torch.cuda.empty_cache()

    check_gpu_against_cpu("shallow", *step_on_gpu_and_cpu(
        torch, "shallow", pre, variant_config(cfg, reuse_aux_forward=True), tc),
        label="train variants cpu, reuse_aux_forward")
    (gm, gg), (cm, cg), flips = step_on_gpu_and_cpu(
        torch, "naive", pre, variant_config(cfg, compute_dtype="bfloat16"), tc)
    bad = [k for k in cm if abs(gm[k] - cm[k]) > (BF16_UPDATED_D_RTOL if k in UPDATED_D_KEYS
                                                  else 1e-4) * abs(cm[k]) + 1e-6]
    largest = max(float(g.norm()) for g in cg.values())
    cosines = {k: float(torch.nn.functional.cosine_similarity(
        gg[k].flatten().double(), g.flatten().double(), dim=0))
        for k, g in cg.items() if float(g.norm()) >= 1e-3 * largest}
    low = {k: c for k, c in cosines.items() if c < BF16_GRAD_COSINE}
    log(f"[train variants cpu, bf16] naive B=2 T=128, GPU against CPU (both bf16): losses "
        + ", ".join(f"{k} {gm[k]:.6f}/{cm[k]:.6f}" for k in sorted(cm))
        + f"; gradients of {len(cosines)} tensors: worst cosine {min(cosines.values()):.6f} "
        f"({len(cg) - len(cosines)} with a norm below 1e-3 of the largest left out); ReLU "
        f"inputs of differing sign (the CPU took the GPU's) {sum(f[1] for f in flips)}")
    if bad or low:
        raise AssertionError(f"bf16 naive: the GPU step disagrees with the CPU step: losses "
                             f"{bad}, cosines {sorted(low.items())[:6]}")


# Phase 15: raw corpus -> preprocessing -> training.  The synthetic corpora
# (utterances, seconds) and the train CLI's step periods on the result.
PREP_LJSPEECH = (48, (2.0, 5.0))
PREP_AISHELL3 = (("SSB0001", "SSB0005", "SSB0012", "SSB0021"), 8, (2.0, 5.0))
PREP_VAL_SIZE = {"LJSpeech": 8, "AISHELL3": 4}
PREP_TRAIN_STEPS = {"total_step_aux": 8, "total_step_shallow": 16, "log_step": 4,
                    "synth_step": 8, "val_step": 10**6, "save_step": 8}
ARTIFACTS = ("mel", "pitch", "energy", "duration", "phones_per_word", "attn_prior")
SYLLABLES = ("ni3", "hao3", "zhong1", "guo2", "ren2", "min2", "yu3", "yin1", "he2", "cheng2",
             "xi4", "tong3", "shi4", "jie4", "wen2", "zi4", "shu1", "ma5", "da4", "xue2")


def synthetic_utterance(r, seconds, sr):
    """A voiced harmonic tone of `seconds` (f0 gliding around 100-220 Hz,
    three harmonics, a syllable-rate envelope, a little noise) and its
    phone boundaries: 60-120 ms phones, the last one a trailing silence of
    ~150 ms.  Returns (wav float32, [phone end times])."""
    import numpy as np
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = r.uniform(100, 220) * (1 + 0.15 * np.sin(2 * np.pi * r.uniform(0.3, 1.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(a * np.sin(k * phase) for k, a in ((1, 0.5), (2, 0.25), (3, 0.12)))
    wav *= 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) ** 2
    speech = seconds - 0.15
    ends = []
    while not ends or ends[-1] < speech - 0.06:
        ends.append(round((ends[-1] if ends else 0.0) + r.uniform(0.06, 0.12), 4))
    ends[-1] = round(speech, 4)
    wav[int(sr * speech):] = 0.0
    wav = wav + 0.003 * r.randn(n)
    return (0.5 * wav / np.abs(wav).max()).astype(np.float32), ends + [round(seconds, 4)]


def textgrid_tiers(phones, ends, words_of):
    """Phone and word tiers of an utterance whose phones end at `ends`
    (the last one the trailing silence); `words_of` lists each word's
    (label, number of phones)."""
    from mixgantts_tpu_torch.data.textgrid import IntervalTier
    starts = [0.0] + ends[:-1]
    phone_iv = list(zip(starts, ends, phones + ["sil"]))
    word_iv, i = [], 0
    for label, n in words_of:
        word_iv.append((starts[i], ends[i + n - 1], label))
        i += n
    word_iv.append((ends[-2], ends[-1], ""))
    return [IntervalTier("words", word_iv), IntervalTier("phones", phone_iv)]


def write_raw_corpora(pre_lj, pre_zh, seed=15):
    """The raw LJSpeech layout (metadata.csv, wavs/) and AISHELL3 layout
    (train/content.txt, train/wav/<speaker>/) at the configs' corpus
    paths, from numpy with `seed`, and the TextGrids the aligner would
    write (`<preprocessed_path>/TextGrid/<speaker>/<basename>.TextGrid`).
    Returns the number of utterances of each."""
    import numpy as np
    from mixgantts_tpu_torch.audio.wav import save_wav
    from mixgantts_tpu_torch.data.textgrid import write_textgrid
    from mixgantts_tpu_torch.text.cmudict import valid_symbols
    from mixgantts_tpu_torch.text.pinyin import pinyin_to_phones
    r = np.random.RandomState(seed)
    sr = pre_lj["preprocessing"]["audio"]["sampling_rate"]
    arpabet = [p for p in valid_symbols if p[-1] in "012" or len(p) <= 2]

    root = pre_lj["path"]["corpus_path"]
    tg_dir = os.path.join(pre_lj["path"]["preprocessed_path"], "TextGrid", "LJSpeech")
    os.makedirs(os.path.join(root, "wavs"))
    os.makedirs(tg_dir)
    n_lj, (lo, hi) = PREP_LJSPEECH
    rows = []
    for k in range(n_lj):
        base = f"LJ{k // 20 + 1:03d}-{k % 20 + 1:04d}"
        wav, ends = synthetic_utterance(r, r.uniform(lo, hi), sr)
        phones = list(r.choice(arpabet, len(ends) - 1))
        words, left = [], len(phones)
        while left:
            n = min(int(r.randint(1, 5)), left)
            words.append((f"w{len(words)}", n))
            left -= n
        save_wav(os.path.join(root, "wavs", f"{base}.wav"), wav, sr)
        write_textgrid(os.path.join(tg_dir, f"{base}.TextGrid"),
                       textgrid_tiers(phones, ends, words), xmax=ends[-1])
        text = " ".join(w for w, _ in words)
        rows.append(f"{base}|{text}|Utterance {k + 1}, {len(words)} words.")
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")

    root = os.path.join(pre_zh["path"]["corpus_path"], "train")
    speakers, per_speaker, (lo, hi) = PREP_AISHELL3
    lines = []
    for spk in speakers:
        os.makedirs(os.path.join(root, "wav", spk))
        tg_dir = os.path.join(pre_zh["path"]["preprocessed_path"], "TextGrid", spk)
        os.makedirs(tg_dir)
        for k in range(per_speaker):
            base = f"{spk}{k + 1:04d}"
            wav, ends = synthetic_utterance(r, r.uniform(lo, hi), sr)
            n_phones = len(ends) - 1
            sylls, phones, words = [], [], []
            while len(phones) < n_phones:
                syl = str(r.choice(SYLLABLES))
                ph = pinyin_to_phones(syl)[:n_phones - len(phones)]
                sylls.append(syl)
                phones += ph
                words.append((syl, len(ph)))
            save_wav(os.path.join(root, "wav", spk, f"{base}.wav"), wav, sr)
            write_textgrid(os.path.join(tg_dir, f"{base}.TextGrid"),
                           textgrid_tiers(phones, ends, words), xmax=ends[-1])
            lines.append(f"{base}.wav\t" + " ".join(f"字 {s}" for s in sylls))
    with open(os.path.join(root, "content.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return n_lj, len(speakers) * per_speaker


def check_preprocessed(pp, n_utts, val_size, speakers):
    """Every artifact family present and finite for each line of train.txt
    and val.txt, and stats.json, speakers.json and the split well formed."""
    import numpy as np
    with open(os.path.join(pp, "stats.json")) as f:
        stats = json.load(f)
    if not (len(stats["pitch"]) == len(stats["energy"]) == 4
            and len(stats["spec_min"]) == len(stats["spec_max"]) == 80
            and np.isfinite(stats["pitch"] + stats["energy"] + stats["spec_min"]
                            + stats["spec_max"]).all() and stats["max_seq_len"] > 0):
        raise AssertionError(f"stats.json is malformed: {stats}")
    with open(os.path.join(pp, "speakers.json")) as f:
        if sorted(json.load(f)) != sorted(speakers):
            raise AssertionError("speakers.json does not list the corpus's speakers")
    lines = {}
    for name in ("train.txt", "val.txt"):
        with open(os.path.join(pp, name), encoding="utf-8") as f:
            lines[name] = [line.split("|") for line in f.read().splitlines()]
    if len(lines["val.txt"]) != val_size or len(lines["train.txt"]) != n_utts - val_size:
        raise AssertionError(f"split {len(lines['train.txt'])}/{len(lines['val.txt'])} of "
                             f"{n_utts} utterances (val_size {val_size})")
    for base, spk, phones, _ in lines["train.txt"] + lines["val.txt"]:
        if spk not in speakers or not phones.startswith("{"):
            raise AssertionError(f"malformed line for {base}")
        for kind in ARTIFACTS:
            a = np.load(os.path.join(pp, kind, f"{spk}-{kind}-{base}.npy"))
            if not np.isfinite(a).all() or a.size == 0:
                raise AssertionError(f"{kind} of {base} is empty or not finite")


def preprocessing_phase(torch):
    """Phase 15: raw corpus -> preprocessing -> training, on the card.  In a
    temporary workspace: the shipped LJSpeech and AISHELL3 configs with
    only `val_size` changed (8, 4: at the shipped 512 these corpora leave
    no training split), raw corpora written here (`write_raw_corpora`:
    48 LJSpeech utterances of 2-5 s, 4 AISHELL3 speakers x 8), then
    `cli.prepare_align` and `cli.preprocess` for each (AISHELL3's
    DeepSpeaker on the card).  Checks every artifact, the split, the
    embeddings' unit norm, DeepSpeaker on the card against the CPU module
    on the same features and weights (max|diff| <= 1e-4 * max|cpu|, TF32
    off), and `TacotronSTFT.mel_spectrogram` on the card on 4 wavs against
    the host `get_mel_from_wav` (mel and energy, max|diff| <= 1e-4 *
    max|host|).  Then the train CLI on the LJSpeech output: 8 aux steps,
    the handoff, 8 shallow steps with `reuse_aux_forward` and
    `compute_dtype: bfloat16`, one panel and one save a run: finite log
    lines, the checkpoint reloads, the shallow panel launches the denoiser
    and MRF kernels and no step launches any.  Prints utterances/s of
    preprocessing, its wall split by part (host clock), and the train
    CLI's steps/s."""
    import copy
    import re
    import numpy as np
    import yaml
    from mixgantts_tpu_torch.audio.stft import TacotronSTFT
    from mixgantts_tpu_torch.audio.wav import load_wav
    from mixgantts_tpu_torch.checkpoint import restore_checkpoint
    from mixgantts_tpu_torch.cli import common
    from mixgantts_tpu_torch.cli import prepare_align, preprocess
    from mixgantts_tpu_torch.cli import train as cli_train
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.models.speaker_embedder import read_mfcc, sample_from_mfcc
    from mixgantts_tpu_torch.train import create_train_state
    configs = {d: get_configs_of(d) for d in ("LJSpeech", "AISHELL3")}
    for d, (pre, _, _) in configs.items():
        pre["preprocessing"]["val_size"] = PREP_VAL_SIZE[d]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as ws:
        os.chdir(ws)
        try:
            for d, (pre, cfg, tc) in configs.items():
                os.makedirs(os.path.join("config", d))
                for name, c in (("preprocess.yaml", pre), ("model.yaml", cfg),
                                ("train.yaml", tc)):
                    with open(os.path.join("config", d, name), "w") as f:
                        yaml.safe_dump(c, f)
            t0 = time.perf_counter()
            counts = dict(zip(configs, write_raw_corpora(configs["LJSpeech"][0],
                                                         configs["AISHELL3"][0])))
            log(f"[prep] raw corpora written in {time.perf_counter() - t0:.2f} s: {counts} "
                f"utterances of {PREP_LJSPEECH[1][0]}-{PREP_LJSPEECH[1][1]} s at "
                f"{configs['LJSpeech'][0]['preprocessing']['audio']['sampling_rate']} Hz")
            pres = {}
            for d, (pre, _, _) in configs.items():
                t0 = time.perf_counter()
                prepare_align.cli(["--dataset", d], device=DEVICE)
                t_align = time.perf_counter() - t0
                t0 = time.perf_counter()
                pres[d], _ = preprocess.cli(["--dataset", d], device=DEVICE)
                wall = time.perf_counter() - t0
                seconds = pres[d].seconds
                log(f"[prep] {d}: prepare_align {t_align:.2f} s; preprocess {wall:.2f} s, "
                    f"{counts[d] / wall:.2f} utterances/s; "
                    + ", ".join(f"{part} {100 * x / wall:.1f}%" for part, x in
                                sorted(seconds.items(), key=lambda kv: -kv[1]))
                    + f", other {100 * (wall - sum(seconds.values())) / wall:.1f}%")
                speakers = (["LJSpeech"] if d == "LJSpeech" else list(PREP_AISHELL3[0]))
                check_preprocessed(pre["path"]["preprocessed_path"], counts[d],
                                   PREP_VAL_SIZE[d], speakers)

            # DeepSpeaker on the card against the CPU module
            pre_zh = configs["AISHELL3"][0]
            embedder = pres["AISHELL3"].speaker_emb
            if embedder.device.type != torch.device(DEVICE).type:
                raise AssertionError(f"DeepSpeaker ran on {embedder.device}")
            raw = pre_zh["path"]["raw_path"]
            wavs = [load_wav(os.path.join(raw, spk, f"{spk}0001.wav"), 22050)[0]
                    for spk in PREP_AISHELL3[0]]
            np.random.seed(0)
            feats = np.stack([sample_from_mfcc(read_mfcc(w, 22050, 1024)) for w in wavs])
            gpu = embedder.embed(feats)
            with torch.no_grad():
                cpu = copy.deepcopy(embedder.module).cpu()(torch.from_numpy(feats)).numpy()
            err = float(np.abs(gpu - cpu).max())
            norms = np.linalg.norm(gpu, axis=-1)
            means = [np.load(os.path.join(pre_zh["path"]["preprocessed_path"], "spker_embed",
                                          f"{spk}-spker_embed.npy")) for spk in PREP_AISHELL3[0]]
            log(f"[prep] DeepSpeaker on the card against the CPU module, 4 utterances: max|diff| "
                f"{err:.3e} (allowed {1e-4 * np.abs(cpu).max():.3e}); norms "
                f"{[f'{x:.6f}' for x in norms]}; speaker means {[m.shape for m in means]}, "
                f"norms {[f'{np.linalg.norm(m):.4f}' for m in means]}")
            if err > 1e-4 * np.abs(cpu).max() or np.abs(norms - 1).max() > 1e-4:
                raise AssertionError("DeepSpeaker on the card disagrees with the CPU module, "
                                     "or an embedding is not unit norm")
            if not all(m.shape == (1, 512) and np.isfinite(m).all() for m in means):
                raise AssertionError("a speaker embedding file is malformed")

            # the batched mel path on the card against the host one
            pre_lj = configs["LJSpeech"][0]
            pp = pre_lj["preprocessing"]
            stft = TacotronSTFT(pp["stft"]["filter_length"], pp["stft"]["hop_length"],
                                pp["stft"]["win_length"], pp["mel"]["n_mel_channels"],
                                pp["audio"]["sampling_rate"], pp["mel"]["mel_fmin"],
                                pp["mel"]["mel_fmax"], device=DEVICE)
            worst = 0.0
            for k in range(4):
                wav, _ = load_wav(os.path.join(pre_lj["path"]["raw_path"], "LJSpeech",
                                               f"LJ001-{k + 1:04d}.wav"), 22050)
                mel, energy = stft.mel_spectrogram(torch.from_numpy(wav).to(DEVICE))
                host = stft.get_mel_from_wav(wav)
                for name, got, want in (("mel", mel[0], host[0]), ("energy", energy[0], host[1])):
                    e = float(np.abs(got.cpu().numpy() - want).max()) / float(np.abs(want).max())
                    worst = max(worst, e)
            log(f"[prep] TacotronSTFT.mel_spectrogram on the card against get_mel_from_wav, "
                f"4 wavs: worst max|diff| / max|host| {worst:.3e} (allowed 1e-4)")
            if worst > 1e-4:
                raise AssertionError("the card's mel spectrogram disagrees with the host's")

            # the train CLI on the LJSpeech output
            pre, cfg, tc = configs["LJSpeech"]
            cfg = variant_config(cfg, reuse_aux_forward=True, compute_dtype="bfloat16")
            tc["step"].update(PREP_TRAIN_STEPS)
            for name, c in (("model.yaml", cfg), ("train.yaml", tc)):
                with open(os.path.join("config", "LJSpeech", name), "w") as f:
                    yaml.safe_dump(c, f)
            meter = CLIMeter(torch, all_kernel_counters())
            wrappers = {"chunk_train_step": meter.chunk_train_step,
                        "synthesize_sample": lambda fn: meter.part("panels", fn),
                        "save_checkpoint": meter.save}
            originals = {name: getattr(cli_train, name) for name in wrappers}
            for name, fn in wrappers.items():
                setattr(cli_train, name, fn(originals[name]))
            try:
                for mode, restore in (("aux", 0), ("shallow", 8)):
                    meter.run = meter.mode = mode
                    args = argparse.Namespace(model=mode, dataset="LJSpeech",
                                              restore_step=restore, path_tag="", seed=0)
                    cli_train.main(args, common.load_configs(args), DEVICE)
            finally:
                for name, fn in originals.items():
                    setattr(cli_train, name, fn)
            ckpt = os.path.join(tc["path"]["ckpt_path"] + "_shallow")
            log_path = tc["path"]["log_path"] + "_shallow"
            with open(os.path.join(log_path, "train", "log.txt")) as f:
                lines = f.read().splitlines()
            numbers = [float(x) for line in lines
                       for x in re.findall(r"-?\d+\.\d+|nan|inf", line.split(", ", 1)[1])]
            if not numbers or not np.isfinite(numbers).all():
                raise AssertionError("a log line of the shallow run is not finite")
            model, _ = common.build_model("shallow", pre, cfg, device=DEVICE)
            disc = common.build_discriminator(pre, cfg, device=DEVICE)
            state = create_train_state(model, disc, tc, cfg)
            restore_checkpoint(ckpt, state, 16)
            if state.step != 16:
                raise AssertionError(f"checkpoint 16 restored step {state.step}")
            del model, disc, state
        finally:
            os.chdir(cwd)
    for mode in ("aux", "shallow"):
        segs = [x for x in meter.segments if x[0] == mode]
        device_ms = sum(start.elapsed_time(end) for _, start, end, _, _, _ in segs)
        steps, host_s = sum(x[3] for x in segs), sum(x[5] for x in segs)
        log(f"[prep train cli] {mode}: {steps} steps in {len(segs)} segments, "
            f"{1e3 * steps / device_ms:.2f} steps/s on CUDA events, {steps / host_s:.2f} on the "
            f"host clock; launches: steps {meter.launches.get((mode, 'steps'))}, panels "
            f"{meter.launches.get((mode, 'panels'))}")
    log(f"[prep train cli] shallow/log.txt, the last of {len(lines)} lines: {lines[-1]}; "
        f"checkpoints {[os.path.basename(x[0]) for x in meter.saves]} (16 reloads)")
    if any(v for (_, part), c in meter.launches.items() if part == "steps" for v in c.values()):
        raise AssertionError(f"a kernel launched inside a train step: {meter.launches}")
    panel = meter.launches.get(("shallow", "panels"), {})
    missing = [k for k in ("fused_residual_stack", "mrf_stack", "mrf_stack_folded")
               if not panel.get(k)]
    if missing:
        raise AssertionError(f"the shallow panel did not launch {missing} ({panel})")


# Phase 16: the multi-device path.  The steps of (a) and (b): (mode, global
# batch) at phase 12's buckets; each rank's timed steps after the compared one.
MULTI_STEPS = (("naive", 8), ("shallow", 4))
MULTI_TIMED = 3
MULTI_CLI_STEPS = {"total_step_aux": 4, "total_step_shallow": 6, "log_step": 1,
                   "synth_step": 6, "val_step": 6, "save_step": 6}
MULTI_CLI_CORPUS = (("train.txt", 16, (600, 1000)), ("val.txt", 4, (600, 1000)))
# the tensors whose gradient is zero by symmetry (phase 12): rounding noise
# decides their Adam step's sign on each side
SYMMETRIC_ZERO = r"(conv_k|w_ks)\.bias$|^postnet\.convolutions\.\d\.0\.conv\.bias$"


def multi_noise(torch, mode, B, M=80, T=1000, S=None, seed=16):
    """Phase 16's injected t and noise for the global batch (numpy, from
    `seed`), one dict per diffusion branch of a GAN step."""
    import numpy as np
    r = np.random.RandomState(seed)
    return [{"t": torch.as_tensor(r.randint(0, S, B)),
             **{k: torch.as_tensor(r.randn(B, T, M).astype(np.float32))
                for k in ("x_t_noise", "x_t_prev_noise", "posterior_noise")}}
            for _ in range(2)]


def multi_reference(torch, pre, cfg, tc, out_dir):
    """The one-process steps (a) and (b) are held against: phase 12's
    build (seed 0) and batch (seed 12), the injected noise of
    `multi_noise`, torch's default generator seeded 1 before the step
    (dropout on, as shipped).  Writes the step's ReLU decisions
    (`SharedReluKinks`, which the ranks' compared steps take) to
    `out_dir/relu_<mode>.pt`, and G's and D's parameters after it to
    `out_dir/ref_<mode>.pt`; returns {mode: metrics}."""
    metrics = {}
    for mode, B in MULTI_STEPS:
        model, disc, state, step_fn = build_training(torch, mode, pre, cfg, tc)
        batch = train_batch(torch, pre, B, 128, 64, 1000, (600, 1000), seed=12)
        noise = multi_noise(torch, mode, B, S=model.diffusion.num_timesteps)
        torch.manual_seed(1)
        kinks = SharedReluKinks(torch)
        with kinks.recording():
            out = step_fn(state, batch, noise_overrides=[
                {k: v.to(DEVICE) for k, v in n.items()} for n in noise])
        metrics[mode] = {k: float(v) for k, v in out.items()}
        for name, obj in (("relu", [m.cpu() for m in kinks.masks]),
                          ("ref", {"G": {k: v.cpu() for k, v in model.state_dict().items()},
                                   "D": {k: v.cpu() for k, v in disc.state_dict().items()}})):
            path = os.path.join(out_dir, f"{name}_{mode}.pt")
            torch.save(obj, path + ".tmp")
            os.replace(path + ".tmp", path)
        del model, disc, state, step_fn, batch
        torch.cuda.empty_cache()
    return metrics


def param_envelope(ref, got, lr):
    """(worst max|diff| / lr, worst share of elements past 1e-2 * lr) of
    the parameters after a step against the one-process step's: Adam's
    first update is +-lr, so a gradient within rounding of 0 may flip it
    (2 * lr); the symmetric-zero tensors count for the first only."""
    import re
    worst, worst_frac, bad = 0.0, 0.0, []
    for name, want in ref.items():
        if "running" in name or "num_batches" in name:
            continue
        diff = (got[name].float() - want.float()).abs()
        worst = max(worst, float(diff.max()) / lr)
        if float(diff.max()) > 2 * lr * (1 + 1e-3) + 1e-6:
            bad.append(f"{name} max|diff| {float(diff.max()):.3g}")
        if not re.search(SYMMETRIC_ZERO, name):
            frac = float((diff > 1e-2 * lr).float().mean())
            worst_frac = max(worst_frac, frac)
            if frac > 1e-2:
                bad.append(f"{name} {frac:.2%} of elements past 1e-2 * lr")
    return worst, worst_frac, bad


def wait_for(path, limit=300):
    """Wait up to `limit` seconds for the file at `path`."""
    deadline = time.time() + limit
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.1)


def multi_rank_worker(args):
    """A rank of phase 16 (a) and (b) (`--multi-worker`): the dp (model
    axis 1) and tp2 (model axis 2) steps of `MULTI_STEPS` at full width on
    this rank's card.  First each compared step (beside whatever else the
    parent runs), its metrics, peak memory, state bytes and, on rank 0, the
    parameters' envelope against `multi_reference`; then, once the parent
    has left the card to the ranks (its `quiet` file) and the ranks have
    met at a barrier, MULTI_TIMED timed steps of each (CUDA events) and
    one traced tp2 naive step (collectives and the device's busy share).
    Writes rank<r>.json."""
    import collections
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.parallel import (
        gather_state, init_distributed, make_mesh, replicate_state, shard_batch, shard_state,
        shard_train_step,
    )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world, dev = init_distributed("cuda", rank=args.rank, world_size=args.world,
                                        init_method=args.init, timeout=600)
    pre, cfg, tc = get_configs_of("LJSpeech")
    runs = []

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        float(out["total_loss"])
        return out, start.elapsed_time(end)

    try:
        for model_axis in (1, 2):
            mesh = make_mesh(model_axis=model_axis)
            for mode, B in MULTI_STEPS:
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                model, disc, state, step_fn = build_training(torch, mode, pre, cfg, tc, dev)
                replicate_state(mesh, state)
                if model_axis > 1:
                    shard_state(mesh, state)
                step = shard_train_step(step_fn, mesh)
                batch = shard_batch(mesh, train_batch(torch, pre, B, 128, 64, 1000, (600, 1000),
                                                      seed=12, device=dev))
                noise = [{k: v.to(dev) for k, v in n.items()}
                         for n in multi_noise(torch, mode, B, S=model.diffusion.num_timesteps)]
                path = os.path.join(args.workdir, f"relu_{mode}.pt")
                wait_for(path)
                kinks = SharedReluKinks(torch, torch.load(path))

                def local(mask, x):   # this rank's rows (data) or channels (model)
                    for d, (n, m) in enumerate(zip(x.shape, mask.shape)):
                        if n != m:
                            mask = mask.narrow(d, mesh.coords["data" if d == 0 else "model"]
                                               * n, n)
                    return mask

                torch.manual_seed(1)
                with kinks.replaying(local):
                    metrics, first_ms = timed(lambda: step(state, batch, noise_overrides=noise))
                res = {"mode": mode, "B": B, "mesh": [mesh.shape["data"], model_axis],
                       "metrics": {k: float(v) for k, v in metrics.items()},
                       "relu_flips": kinks.flips, "first_ms": first_ms,
                       "peak": torch.cuda.max_memory_allocated(dev) - base,
                       "param_bytes": sum(p.numel() * p.element_size()
                                          for p in model.parameters()),
                       "moment_bytes": sum(m.numel() * m.element_size()
                                           for m in state.opt_g.mu + state.opt_g.nu)}
                with gather_state(state):
                    res["full_bytes"] = sum(p.numel() * p.element_size()
                                            for p in model.parameters())
                    if rank == 0:
                        path = os.path.join(args.workdir, f"ref_{mode}.pt")
                        wait_for(path)
                        ref = torch.load(path)
                        res["envelope"] = {tag: param_envelope(
                            ref[tag], {k: v.cpu() for k, v in module.state_dict().items()}, lr)
                            for tag, module, lr in (("G", model, tc["optimizer"]["init_lr_G"]),
                                                    ("D", disc, tc["optimizer"]["init_lr_D"]))}
                runs.append((res, step, state, batch))
        wait_for(os.path.join(args.workdir, "quiet"), limit=600)
        for res, step, state, batch in runs:
            dist.barrier()   # the ranks start each timed run together
            res["times"] = [timed(lambda: step(state, batch))[1] for _ in range(MULTI_TIMED)]
            if res["mesh"][1] > 1 and res["mode"] == "naive":
                # one traced step (rank 0's; the other rank steps beside it)
                if rank == 0:
                    path = os.path.join(args.workdir, "tp2_naive_step_trace.json")
                    summary = trace(torch, lambda: float(step(state, batch)["total_loss"]),
                                    path, "multi tp2 trace")
                    ops = collections.Counter(
                        e["name"] for e in summary.events if e.get("ph") == "X" and
                        e.get("name", "").startswith(("gloo:", "nccl:", "c10d::")))
                    res["trace"] = {"collectives": dict(ops), "kernels": summary.kernels,
                                    "busy_ms": summary.busy_ms, "wall_ms": summary.wall_ms}
                else:
                    float(step(state, batch)["total_loss"])
        with open(os.path.join(args.workdir, f"rank{rank}.json"), "w") as f:
            json.dump([res for res, *_ in runs], f)
    finally:
        dist.destroy_process_group()


def multi_train_steps(torch, world, topology, workdir, meanwhile=None):
    """Phase 16 (a) and (b): one data-parallel step per mode on `world`
    ranks (naive B=8, shallow B=4, bucket 1000, full width), then the same
    at tp2, against the one-process step on the same batch, noise and
    dropout draws, the ranks taking its ReLU decisions (`SharedReluKinks`;
    each input of differing sign within 1e-5 of its call's max|x|): the
    metrics at phase 12's rtol 1e-4, the parameters after the step within
    Adam's sign-flip envelope (every element within 2 * lr, >= 99% within
    1e-2 * lr outside the symmetric-zero tensors).
    The ranks take their compared steps while this process runs the
    one-process reference and then `meanwhile` (other work of the phase),
    and time theirs after it, with the card to themselves.  Prints each
    rank's step time (median of MULTI_TIMED, CUDA events), peak memory,
    parameter and moment bytes against one GPU's, and the traced tp2
    step's collectives and device busy share."""
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.parallel.launch import start_ranks
    pre, cfg, tc = get_configs_of("LJSpeech")
    t0 = time.perf_counter()
    ranks = start_ranks([sys.executable, "-u", os.path.abspath(__file__), "--multi-worker",
                         "--workdir", workdir], world, workdir, cwd=REPO,
                        label="phase 16 train ranks")
    try:
        ref = multi_reference(torch, pre, cfg, tc, workdir)
        t_ref = time.perf_counter() - t0
        if meanwhile is not None:
            meanwhile()
    finally:
        open(os.path.join(workdir, "quiet"), "w").close()
        t_quiet = time.perf_counter()
        ranks.join(600)
    log(f"[multi] {world} ranks ({topology}): the one-process reference took {t_ref:.1f} s "
        f"of the ranks' start, the ranks' timed steps {time.perf_counter() - t_quiet:.1f} s "
        f"after the rest of the phase had left the card")
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    failed = []
    for i, res0 in enumerate(ranks[0]):
        mode, (D, M) = res0["mode"], res0["mesh"]
        label = f"{mode} B={res0['B']} bucket 1000, mesh data {D} x model {M}"
        want = ref[mode]
        for r, rank in enumerate(ranks):
            got = rank[i]["metrics"]
            bad = [k for k in want if abs(got[k] - want[k]) > 1e-4 * abs(want[k]) + 1e-6]
            if bad:
                failed.append(f"{label} rank {r}: metrics {bad}")
        env = res0["envelope"]
        flips = [f for rank in ranks for f in rank[i]["relu_flips"]]
        log(f"[multi] {label}: ReLU inputs of differing sign from one process's (the ranks "
            f"took its): {sum(f[1] for f in flips)} in {len(flips)} calls, the largest "
            f"{max([f[2] for f in flips], default=0.0):.2e} of its call's max|x| (bar 1e-5)")
        if any(f[2] > 1e-5 for f in flips):
            failed.append(f"{label}: ReLU inputs of differing sign beyond rounding {flips[:4]}")
        log(f"[multi] {label}: metrics against one process "
            + ", ".join(f"{k} {res0['metrics'][k]:.6f}/{want[k]:.6f}" for k in
                        ("total_loss", "D_loss", "G_loss", "mel_loss"))
            + "; parameters: " + ", ".join(
                f"{tag} worst max|diff| {e[0]:.3f} lr, worst share past 1e-2 lr {e[1]:.2e}"
                for tag, e in env.items()))
        for tag, (_, _, bad) in env.items():
            if bad:
                failed.append(f"{label} {tag}: {bad[:4]}")
        for r, rank in enumerate(ranks):
            res = rank[i]
            log(f"  rank {r}: step median {statistics.median(res['times']):.2f} ms "
                f"({', '.join(f'{x:.2f}' for x in res['times'])}; CUDA events), the compared "
                f"first step {res['first_ms']:.2f} ms, its peak memory "
                f"{res['peak'] / 2**30:.2f} GiB, parameters {res['param_bytes'] / 2**20:.1f} MiB "
                f"of one GPU's {res['full_bytes'] / 2**20:.1f} MiB, G's Adam moments "
                f"{res['moment_bytes'] / 2**20:.1f} MiB of {2 * res['full_bytes'] / 2**20:.1f}")
        if "trace" in res0:
            t = res0["trace"]
            log(f"  rank 0's traced step: wall {t['wall_ms']:.2f} ms, {t['kernels']} kernels, "
                f"device busy {t['busy_ms']:.2f} ms ({100 * t['busy_ms'] / t['wall_ms']:.1f}% of "
                f"wall; this rank's kernels), collectives "
                f"{sum(n for k, n in t['collectives'].items() if not k.startswith('c10d::'))} "
                f"({t['collectives']})")
    if failed:
        raise AssertionError("phase 16: sharded steps disagree with one process: "
                             + "; ".join(failed[:6]))


def read_log_lines(path):
    import re
    with open(path) as f:
        return [(line.split(",")[0], [float(x) for x in re.findall(r"-?\d+\.\d+", line)])
                for line in f.read().splitlines()]


def same_losses(label, got, want, rtol=1e-3, atol=5e-5):
    """Log lines of two train CLI runs: the same steps, every number within
    rtol (phase 13's resume bar) plus atol (printing's 5e-5)."""
    if [g[0] for g in got] != [w[0] for w in want]:
        raise AssertionError(f"{label}: steps {[g[0] for g in got]} vs {[w[0] for w in want]}")
    worst = 0.0
    for (_, a), (_, b) in zip(got, want):
        for x, y in zip(a, b):
            worst = max(worst, abs(x - y) / (abs(y) + 1e-9))
            if abs(x - y) > rtol * abs(y) + atol:
                raise AssertionError(f"{label}: {a} against {b}")
    return worst


def train_cli_rank(out_dir, argv):
    """A rank of phase 16 (c), started by torchrun: the train CLI's
    `cli(argv)` (what `python -m mixgantts_tpu_torch.cli.train argv` runs),
    with the serving kernels' launches counted (set to 0 just before, read
    just after) into out_dir/launches<rank>.json."""
    import torch
    sys.path.insert(0, REPO)
    from mixgantts_tpu_torch.cli import train as cli_train
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    cli_train.cli(argv)
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"launches{os.environ['RANK']}.json"), "w") as f:
        json.dump({name: c.launches for name, c in counters.items()}, f)


def multi_cli(torch, world, workdir, records):
    """Phase 16 (c): the train CLI under `torchrun --nproc_per_node <world>`
    (each rank `train_cli_rank`) with `--data_parallel --tensor_parallel
    <world> --profile_dir` for 2 shallow steps (4 -> 6, from a handoff
    checkpoint of phase 12's aux weights) on a synthetic corpus
    (`write_corpus`), with a panel, validation and a save at 6; the same
    run in one process beside it; then `cli.evaluate` (one process) from
    the torchrun run's checkpoint.  Every rank's trace file exists; rank 0
    alone runs the panel and validation, on the gathered weights, and
    launches the serving kernels there (added to `records`); the torchrun
    run's first train line equals the one-process run's (rtol 1e-3), its
    other lines stay in family (rtol 0.05, atol 0.05); the evaluate run's
    loss line equals the torchrun run's validation line (rtol 1e-3)."""
    import glob
    import re
    import socket
    import yaml
    from mixgantts_tpu_torch.checkpoint import save_checkpoint
    from mixgantts_tpu_torch.cli import common, evaluate
    from mixgantts_tpu_torch.cli import train as cli_train
    from mixgantts_tpu_torch.config import get_configs_of
    pre, cfg, tc = get_configs_of("LJSpeech")
    tc["step"].update(MULTI_CLI_STEPS)
    ws = os.path.join(workdir, "cli")
    cfg_dir = os.path.join(ws, "config", "LJSpeech")
    os.makedirs(cfg_dir)
    for name, c in (("preprocess.yaml", pre), ("model.yaml", cfg), ("train.yaml", tc)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.safe_dump(c, f)
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        write_corpus(pre["path"]["preprocessed_path"],
                     pre["preprocessing"]["mel"]["n_mel_channels"], MULTI_CLI_CORPUS)
        handoff = MULTI_CLI_STEPS["total_step_aux"]

        def configs_of(tag, restore):
            return common.load_configs(argparse.Namespace(
                model="shallow", dataset="LJSpeech", restore_step=restore, path_tag=tag))

        model, disc, state, _ = build_training(torch, "aux", pre, cfg, tc)
        state.step = handoff
        for tag in ("tp", "one"):
            save_checkpoint(configs_of(tag, handoff)[2]["path"]["ckpt_path"], state, tc)
        del model, disc, state
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        prof = os.path.join(ws, "profile")
        env = dict(os.environ, PYTHONPATH=REPO)
        argv = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={world}",
                "--master_addr=localhost", f"--master_port={port}", os.path.abspath(__file__),
                "--train-cli-rank", ws, "--model", "shallow", "--dataset", "LJSpeech",
                "--restore_step", str(handoff), "--path_tag", "tp", "--data_parallel",
                "--tensor_parallel", str(world), "--profile_dir", prof]
        t0 = time.perf_counter()
        out_path = os.path.join(ws, "torchrun.log")
        with open(out_path, "w") as out:
            proc = subprocess.Popen(argv, env=env, stdout=out, stderr=subprocess.STDOUT)
            try:
                # the one-process run of the same steps, meanwhile
                cli_train.main(argparse.Namespace(
                    model="shallow", dataset="LJSpeech", restore_step=handoff, path_tag="one",
                    seed=0, data_parallel=False, tensor_parallel=1, steps_per_call=0,
                    profile_dir=None, profile_port=0), configs_of("one", handoff), DEVICE)
                proc.wait(timeout=400)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        with open(out_path) as f:
            text = f.read()
        if proc.returncode:
            raise AssertionError(f"torchrun train CLI failed ({proc.returncode}):\n{text[-4000:]}")
        log(f"[multi cli] torchrun, {world} ranks (tp{world}), and the one-process run beside "
            f"it: {wall:.1f} s (process start included); the torchrun run printed:")
        for line in text.splitlines():
            if line.startswith(("torch.distributed", "Step", "saved", "profiler")):
                log(f"  {line[:150]}")
        traces = {r: glob.glob(os.path.join(prof, f"rank{r}", "*.pt.trace.json"))
                  for r in range(world)}
        if not all(traces.values()):
            raise AssertionError(f"--profile_dir: a rank wrote no trace: {traces}")
        launches = []
        for r in range(world):
            with open(os.path.join(ws, f"launches{r}.json")) as f:
                launches.append(json.load(f))
        panel = launches[0]
        if not all(panel.values()) or any(any(n.values()) for n in launches[1:]):
            raise AssertionError(f"the panel and validation ran the serving kernels on ranks "
                                 f"{launches} (all on rank 0, none elsewhere expected)")
        for name, n in panel.items():
            records[name]["launches"] += n
        logs = {tag: {part: read_log_lines(os.path.join(
            configs_of(tag, handoff)[2]["path"]["log_path"], part, "log.txt"))
            for part in ("train", "val")} for tag in ("tp", "one")}
        # the first line is two steps from the same state; later ones have
        # met Adam's sign-like first updates of near-zero gradients, which
        # reduction order flips, so they are held in family (the JAX
        # package's bar for a step past the first, test_parallel_dp.py:174-178)
        first = same_losses("torchrun train log, first line", logs["tp"]["train"][:1],
                            logs["one"]["train"][:1])
        later = max(same_losses(f"torchrun {part} log", logs["tp"][part], logs["one"][part],
                                rtol=0.05, atol=0.05) for part in ("train", "val"))
        # the torchrun run's checkpoint restores in a one-process CLI run
        end = MULTI_CLI_STEPS["total_step_shallow"]
        message = evaluate.cli(["--restore_step", str(end), "--model", "shallow", "--dataset",
                                "LJSpeech", "--path_tag", "tp"], device=DEVICE)
        again = same_losses("cli.evaluate on the torchrun checkpoint",
                            [(message.split(",")[0], [float(x) for x in re.findall(
                                r"-?\d+\.\d+", message)])], logs["tp"]["val"])
        log(f"[multi cli] against the one-process run: the first train line worst relative "
            f"diff {first:.2e} (allowed 1e-3), the train and val lines {later:.2e} (in family: "
            f"rtol 0.05); cli.evaluate on the torchrun checkpoint against its validation line "
            f"{again:.2e} (allowed 1e-3); trace files per rank "
            f"{ {r: len(t) for r, t in traces.items()} }; the serving kernels' launches per "
            f"rank (the panel and validation, on rank 0's gathered weights) {launches}")
    finally:
        os.chdir(cwd)


def multi_serving(torch, pre, cfg, model, vocoder, records, devices):
    """Phase 16 (d): B=4 at bucket 512 through `TTSPipeline(mesh=devices)`,
    one replica per entry, against the single-replica pipeline with the
    same generator seed: equal lengths, the mel at rtol 1e-4 (atol 2e-2,
    `tests/test_parallel_serving.py`'s bars), int16 within 2; every replica
    launches the serving kernels (counts set to 0 just before, read just
    after, added to the kernels line); latency (host clock, median of 5)
    beside the single replica's."""
    import numpy as np
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    four = text_batch(4, 32, 12, seed=1)
    single = TTSPipeline(model, vocoder, pre, cfg, mel_dtype=torch.float32)
    sharded = TTSPipeline(model, vocoder, pre, cfg, mesh=devices, mel_dtype=torch.float32)
    gen = lambda: torch.Generator(DEVICE).manual_seed(5)
    want = single(four, generator=gen())
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    got = sharded(four, generator=gen())
    sync(torch)
    launches = {name: c.launches for name, c in counters.items()}
    for name, n in launches.items():
        records[name]["launches"] += n
    n = len(devices)
    if launches["fused_residual_stack"] < n or launches["mrf_stack"] < 18 * n or \
            launches["mrf_stack_folded"] < 18 * n:
        raise AssertionError(f"a replica did not launch the serving kernels: {launches}")
    if not np.array_equal(got[2], want[2]):
        raise AssertionError(f"sharded serving lengths {got[2]} against {want[2]}")
    mel_err = float(np.abs(got[1] - want[1]).max())
    if not np.allclose(got[1], want[1], rtol=1e-4, atol=2e-2):
        raise AssertionError(f"sharded serving mel off the single pipeline's by {mel_err}")
    wav_err = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
                  for a, b in zip(got[0], want[0]))
    if wav_err > 2:
        raise AssertionError(f"sharded serving wav off the single pipeline's by {wav_err} LSB")
    times = {}
    for label, pipe in (("single", single), (f"{n} replicas", sharded)):
        pipe(four)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            pipe(four, return_mel=False)
            ts.append(time.perf_counter() - t0)
        times[label] = statistics.median(ts)
    log(f"[multi serve] B=4 bucket 512 over {[str(d) for d in devices]}: launches {launches}; "
        f"mel max|diff| {mel_err:.2e}, int16 max|diff| {wav_err}; latency (host clock, "
        f"median of 5) " + ", ".join(f"{k} {1e3 * v:.2f} ms" for k, v in times.items()))


def multi_device_phase(torch, pre, cfg, model, vocoder, records):
    """Phase 16: the multi-device path on the card(s): (a) and (b) on two
    ranks (`multi_train_steps`), with (c) the train CLI under torchrun
    (`multi_cli`) and (e) `dryrun_multigpu(2)` run while those ranks take
    their compared steps, (d) sharded serving over two replicas of cuda:0;
    with >= 2 cards, (f): (a), (b) and (d) again over min(count, 4) cards
    and nccl.  Prints its topology and wall time."""
    import threading
    from mixgantts_tpu_torch.dryrun import dryrun_multigpu
    from mixgantts_tpu_torch.parallel import choose_backend
    t_start = time.perf_counter()
    count = torch.cuda.device_count()
    backend, _, topology = choose_backend("cuda", 0, 2)
    log(f"[multi] {count} card(s) visible; two ranks: {topology}")
    with tempfile.TemporaryDirectory() as tmp:
        dry = {}

        def run_dryrun():
            try:
                dryrun_multigpu(2, device="cuda", timeout=300)
            except Exception as e:   # re-raised below
                dry["error"] = e

        def cli_and_dryrun():
            t0 = time.perf_counter()
            thread = threading.Thread(target=run_dryrun)   # (e), beside (c)
            thread.start()
            try:
                multi_cli(torch, 2, tmp, records)
            finally:
                thread.join()
            if "error" in dry:
                raise dry["error"]
            log(f"[multi] (c) and (e) took {time.perf_counter() - t0:.1f} s, beside the "
                f"compared steps of (a) and (b)")

        # (a) and (b), with (c) and (e) run while their ranks take the
        # compared steps, and nothing beside their timed ones
        multi_train_steps(torch, 2, topology, tmp, meanwhile=cli_and_dryrun)
        multi_serving(torch, pre, cfg, model, vocoder, records, [torch.device(DEVICE)] * 2)
        if count >= 2:
            n = min(count, 4)
            _, _, topology = choose_backend("cuda", 0, n)
            log(f"[multi] (f) {n} cards: {topology}")
            with tempfile.TemporaryDirectory() as tmp_f:
                multi_train_steps(torch, n, topology, tmp_f)
            multi_serving(torch, pre, cfg, model, vocoder, records,
                          [torch.device(f"cuda:{i}") for i in range(n)])
        else:
            log("[multi] (f) skipped: one card visible, so no nccl run across cards")
    log(f"[multi] phase 16 took {time.perf_counter() - t_start:.1f} s")


BENCH_SCRIPT_ITERS = 5     # calls a round of phase 17's runs of the tests/bench_torch_*.py


def bench_phase(torch, pre, cfg, model, vocoder, records):
    """Phase 17: the port's benchmark and measuring tools.  (a) `python -m
    mixgantts_tpu_torch.bench` in a subprocess: a non-zero exit, a null
    value or a serving kernel launched no time fails; (b) one request at
    the bench's shapes (`example_text_batch(1, 64, 24)`, max_mel_len 864,
    the whole mel vocoded: `bench.synthesize`) on phase 4's weights, the
    serving kernels' launches counted, against the CPU at phase 5's bars
    with the same injected noise; (c) `tests/bench_torch_serving.py` at B=1
    (call) and B=8 (stream), `tests/bench_torch_step_parts.py` and
    `tests/bench_torch_denoiser_grad.py`, in this process, each once with
    BENCH_SCRIPT_ITERS calls a round.  Prints the wall time."""
    import re
    import numpy as np
    from mixgantts_tpu_torch import bench
    from mixgantts_tpu_torch.flagship import example_text_batch
    t_start = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "mixgantts_tpu_torch.bench"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    for line in out.stderr.splitlines():
        if line.startswith("[bench]") or out.returncode:
            log(f"  {line}")
    result = json.loads(out.stdout.strip().splitlines()[-1]) if out.stdout.strip() else {}
    log(f"[bench] (a) rc {out.returncode}: {json.dumps(result)}")
    launched = re.search(r"launches per request (\{.*\})", out.stderr)
    launched = json.loads(launched.group(1)) if launched else {}
    if out.returncode or result.get("value") is None or sorted(launched) != sorted(
            kernel_counters()) or not all(launched.values()):
        raise AssertionError(f"the benchmark failed: rc {out.returncode}, {result}, "
                             f"launches per request {launched}")

    cpu_model, cpu_voc = cpu_copy(torch, pre, cfg, model, vocoder)
    arrays = example_text_batch(B=1, P=bench.P, W=bench.W, rng=0)
    T, M = bench.MAX_MEL_LEN, model.n_mels
    r = np.random.RandomState(17)
    noise = {"start_noise": r.randn(1, T, M).astype(np.float32),
             "step_noises": r.randn(model.diffusion.num_timesteps, 1, T, M).astype(np.float32)}
    max_wav = pre["preprocessing"]["audio"]["max_wav_value"]

    def serve(m, v):
        device = next(m.parameters()).device
        wav, mel, lens = bench.synthesize(
            m, v, {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}, T,
            noise_override={k: torch.as_tensor(a, device=device) for k, a in noise.items()})
        wav = torch.clamp(wav * max_wav, -max_wav, max_wav - 1).to(torch.int16)
        return wav.cpu().numpy(), mel.float().cpu().numpy(), lens.cpu().numpy()

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = on_gpu_and_cpu(torch, model, vocoder, cpu_model, cpu_voc, serve)   # the CPU counts none
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[bench] (b) one request at the bench's shapes (B=1, P={bench.P}, W={bench.W}, "
        f"T={T}, the whole mel vocoded): launches {launches}")
    for name, n in launches.items():
        records[name]["launches"] += n
        if n == 0:
            raise AssertionError(f"{name} was not launched at the bench's shapes")
    check_against_cpu("bench (b)", T, M, *outs, vocoded_on_both(torch, vocoder, cpu_voc, outs[1]))

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import bench_torch_denoiser_grad
    import bench_torch_serving
    import bench_torch_step_parts
    log(f"[bench] (c) the manual benches, {BENCH_SCRIPT_ITERS} calls a round")
    for B, variant in ((1, "call"), (8, "stream")):
        bench_torch_serving.main(B, variant, iters=BENCH_SCRIPT_ITERS)
    bench_torch_step_parts.main(iters=BENCH_SCRIPT_ITERS)
    bench_torch_denoiser_grad.main(iters=BENCH_SCRIPT_ITERS)
    log(f"[bench] phase 17 took {time.perf_counter() - t_start:.1f} s")


def random_stack(torch, L, C, Hc, g, speaker_dim=0):
    """Stacked denoiser weights [L, ...] at width C from generator g,
    scaled like an initialised layer's."""
    def t(*shape, scale):
        return torch.randn(*shape, device=g.device, generator=g) * scale
    st = {"conv_w": t(L, 3, C, 2 * C, scale=(3 * C) ** -0.5), "conv_b": t(L, 2 * C, scale=0.1),
          "cond_w": t(L, Hc, C, scale=Hc ** -0.5), "cond_b": t(L, C, scale=0.1),
          "step_w": t(L, C, C, scale=C ** -0.5),
          "out_w": t(L, C, 2 * C, scale=C ** -0.5), "out_b": t(L, 2 * C, scale=0.1)}
    if speaker_dim:
        st["spk_w"] = t(L, speaker_dim, C, scale=speaker_dim ** -0.5)
    return st


def time_denoiser(torch, label, B, T, stacked):
    """The kernel's and the plain version's time (CUDA events) on random
    inputs, and the bound of the stack's own work at width C (bf16 peak);
    returns (kernel ms, plain ms, bound ms, bound by)."""
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    L, _, C, _ = stacked["conv_w"].shape
    Hc = stacked["cond_w"].shape[1]
    g = torch.Generator("cuda").manual_seed(T)
    x, cond, step = (torch.randn(*shape, device="cuda", generator=g)
                     for shape in ((B, T, C), (B, T, Hc), (B, C)))
    with torch.no_grad():
        warm_up(lambda: den.fused_residual_stack(x, cond, step, stacked))
        ms1 = time_ms(lambda: den.fused_residual_stack(x, cond, step, stacked), 20)
        plain = time_ms(lambda: den.fused_residual_stack_plain(x, cond, step, stacked), 20)
        ms2 = time_ms(lambda: den.fused_residual_stack(x, cond, step, stacked), 20)
    b, by = bound_ms(*denoiser_work(B, T, C, Hc, L, weight_bytes=2), PEAK_BF16_FLOPS)
    ctas, cluster, _ = den.launch_shape(B, T, C)
    log(f"  {label} B={B} T={T} C={C} (run at {den.kernel_width(C)}) L={L} Hc={Hc}: kernel "
        f"{ms1:.4f}/{ms2:.4f} ms, plain (bf16) {plain:.4f} ms, bound {b:.5f} ms at bf16 "
        f"({by}) for the C={C} stack; {ctas} CTAs in clusters of {cluster}")
    return (ms1 + ms2) / 2, plain, b, by


def denoiser_widths(torch, rec, widths, seed):
    """Phase 18 (a) and 19 (d): the denoiser kernel against its plain
    version at every C in `widths`, B in {1, 4}, T = 300, 20 layers, with
    and without a speaker term, its launch count rising at each call; the
    errors into `rec`.  Returns the launches."""
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    g = torch.Generator("cuda").manual_seed(seed)
    L, Hc, H, T = 20, 64, 64, 300
    launches = 0
    for C in widths:
        kw = den.denoiser_kernel_weights(random_stack(torch, L, C, Hc, g, speaker_dim=H))
        for B in (1, 4):
            x = torch.randn(B, T, C, device="cuda", generator=g)
            cond = torch.randn(B, T, Hc, device="cuda", generator=g)
            step = torch.randn(B, C, device="cuda", generator=g)
            emb = torch.randn(B, H, device="cuda", generator=g)
            for spk in (None, den.speaker_projections(emb, kw)):
                n0 = den.fused_residual_stack.launches
                with torch.no_grad():
                    got = den.fused_residual_stack(x, cond, step, kw, spk)
                    sync(torch)
                    if den.fused_residual_stack.launches == n0:
                        raise AssertionError(f"C={C} B={B}: the denoiser kernel did not launch")
                    launches += den.fused_residual_stack.launches - n0
                    want = den.fused_residual_stack_plain(x, cond, step, kw, spk)
                if den.is_wide(C) and den.fused_residual_stack.launches - n0 != 2 * L:
                    raise AssertionError(f"C={C} B={B}: the wide route launched "
                                         f"{den.fused_residual_stack.launches - n0} times, "
                                         f"want {2 * L}")
                for part, a, b in zip(("x", "skip"), got, want):
                    rec["err"] = max(rec["err"], check_close(
                        f"fused_residual_stack C={C} (at {den.kernel_width(C)}) B={B} T={T} "
                        f"{'speaker ' if spk is not None else ''}{part} (bf16)", a, b, BF16_TOL))
    return launches


def narrow_widths(torch, records):
    """Phase 18 (a): the denoiser kernel at every C in NARROW_WIDTHS; its
    time at C = 16 and 64."""
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    denoiser_widths(torch, records["fused_residual_stack_c16"], NARROW_WIDTHS, seed=18)
    g = torch.Generator("cuda").manual_seed(18)
    L = 20
    for C in (16, 64):
        time_denoiser(torch, "fused_residual_stack", 1, 1000,
                      den.denoiser_kernel_weights(random_stack(torch, L, C, 256, g)))


def horizon_phase(torch, records):
    """Phase 18: (a) `narrow_widths`; (b) the long-horizon drive's stages
    at HORIZON_STEPS; (c) the synthesis CLI in process on its checkpoint,
    launches counted; then the restored model and the CLI's vocoder on the
    same text against the CPU at phase 5's bars with injected noise
    (`check_against_cpu`), each MRF kernel against its plain version at
    the stages this request gives it, and the denoiser's stack against its
    plain version, timed (the `fused_residual_stack_c16` record)."""
    import types

    import numpy as np
    from mixgantts_tpu_torch.cli.common import build_model, restore_generator
    from mixgantts_tpu_torch.cli.synthesize import build_single_batch, cli
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    from mixgantts_tpu_torch.ops import mrf
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    from mixgantts_tpu_torch.utils.tools import bucket_length
    t_start = time.perf_counter()
    narrow_widths(torch, records)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import train_horizon_torch as horizon
    aux_steps, shallow_steps = HORIZON_STEPS
    final = aux_steps + shallow_steps
    rec = records["fused_residual_stack_c16"]
    counters = kernel_counters()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        drive = horizon.Drive(os.path.join(tmp, "ws"))
        aux, sh, rdir = horizon.aux_shallow(drive, aux_steps, shallow_steps)
        pcm = horizon.read_wav(rdir)
        log(f"[horizon] (b) aux {aux_steps} -> shallow {shallow_steps} -> synthesize: "
            f"{len(aux)} + {len(sh)} log rows, wall by CLI run "
            f"{ {k: round(v, 1) for k, v in drive.walls.items()} } s; wav {len(pcm)} samples, "
            f"std {np.std(pcm):.4f}; last aux row {aux[-1]}, last shallow row {sh[-1]}")
        if not horizon.all_finite(aux + sh) or len(pcm) == 0 or not np.isfinite(pcm).all():
            raise AssertionError("the horizon's stages logged a non-finite metric or wrote "
                                 "no wav")
        os.chdir(drive.ws)
        try:
            for fn in counters.values():
                fn.launches = 0
            written = cli(["--restore_step", str(final), "--model", "shallow", "--mode",
                           "single", "--text", "hello world", "--dataset", "TestCorpus"])
            sync(torch)
            launches = {name: fn.launches for name, fn in counters.items()}
            pre, cfg, tc = get_configs_of("TestCorpus")
            batch = build_single_batch(types.SimpleNamespace(text="hello world", speaker_id=0),
                                       pre, cfg)
        finally:
            os.chdir(cwd)
        models = {}
        for device in ("cuda", "cpu"):   # the CLI's model and vocoder, and their CPU copies
            m, _ = build_model("shallow", pre, cfg, device=device)
            restore_generator(m, f"{tc['path']['ckpt_path']}_shallow", final)
            models[device] = m, get_vocoder(
                cfg, num_mels=pre["preprocessing"]["mel"]["n_mel_channels"], device=device)
        (model, vocoder), (cpu_model, cpu_voc) = models["cuda"], models["cpu"]
        cpu_voc.generator.load_state_dict(vocoder.generator.state_dict())
    log(f"[horizon] (c) the synthesis CLI in process at residual_channels "
        f"{cfg['denoiser']['residual_channels']}: mel length {written[0][1]}, launches "
        f"{launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched by the horizon's synthesis")
        records[name if name != "fused_residual_stack" else rec["name"]]["launches"] += n

    # the request the CLI served, at the frame budget `TTSPipeline.submit` gives its text
    T = bucket_length(min(cfg["max_seq_len"], max(64, batch["texts"].shape[1] * 16)),
                      cfg["tpu"]["length_buckets"])
    M = model.n_mels
    r = np.random.RandomState(18)
    noise = {"start_noise": r.randn(1, T, M).astype(np.float32),
             "step_noises": r.randn(model.diffusion.num_timesteps, 1, T, M).astype(np.float32)}
    outs = on_gpu_and_cpu(torch, model, vocoder, cpu_model, cpu_voc, lambda m, v: TTSPipeline(
        m, v, pre, cfg, mel_dtype=torch.float32)(batch, noise_override=noise))
    check_against_cpu("horizon (c)", T, M, *outs,
                      vocoded_on_both(torch, vocoder, cpu_voc, outs[1]))
    g = torch.Generator("cuda").manual_seed(19)
    gen = vocoder.generator
    dils = gen.resblock_dilation_sizes[0]
    with torch.no_grad():
        for stage, (C, Tw, call) in enumerate(mrf_calls(gen, gen.resblock_kernel_sizes, dils,
                                                        T_mel=T)):
            x = torch.randn(1, Tw, C, device="cuda", generator=g)
            for name, st, ks, run in call:
                got = run(x)
                want = mrf.mrf_stack_plain(x, st, ks, dils)
                sync(torch)
                records[name]["err"] = max(records[name]["err"], check_close(
                    f"{name}, the horizon's vocoder at frame bucket {T}: stage {stage} C={C} "
                    f"T={Tw} k={ks} (bf16)", got, want, BF16_TOL))
    stacked = model.diffusion.denoise_fn.stacked()
    C, Hc = stacked["conv_w"].shape[-2], stacked["cond_w"].shape[1]
    x, cond, step = (torch.randn(*shape, device="cuda", generator=g)
                     for shape in ((1, T, C), (1, T, Hc), (1, C)))
    with torch.no_grad():
        for part, a, b in zip(("x", "skip"), den.fused_residual_stack(x, cond, step, stacked),
                              den.fused_residual_stack_plain(x, cond, step, stacked)):
            rec["err"] = max(rec["err"], check_close(
                f"fused_residual_stack, the horizon's denoiser at B=1 T={T} {part} (bf16)",
                a, b, BF16_TOL))
    ms, plain, b, by = time_denoiser(torch, "the horizon's denoiser", 1, T, stacked)
    rec.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    log(f"[horizon] phase 18 took {time.perf_counter() - t_start:.1f} s")

def mrf_widths(torch, records):
    """Phase 19 (a): the MRF kernels against their bf16 plain version at
    every C in MRF_WIDTHS (run at 8, 16, 32, 64, 128 or 256 with zero
    channels above C), B in {1, 4}: the whole three-branch stage up to
    C = 128 (the folded entry point where F = 128 / C divides the frames, as
    `fused_apply` calls it), one branch a call above; each call's launch
    count must rise by what its route launches (`stage_launches`: one at
    C <= 16, the narrow stages' kernel, whose error goes to its record)."""
    from mixgantts_tpu_torch.models.hifigan import stage_mode
    from mixgantts_tpu_torch.ops import mrf
    g = torch.Generator("cuda").manual_seed(19)
    T = 4096
    for C in MRF_WIDTHS:
        mode = stage_mode(C, T)
        calls = [(3, 7, 11)] if C <= 128 else [(3,), (7,), (11,)]
        for B in (1, 4):
            x = torch.randn(B, T, C, device="cuda", generator=g)
            for ks in calls:
                st = mrf.kernel_weights(random_mrf(torch, C, ks, g), ks)
                fn = mrf.mrf_stack_folded if mode == "folded" else mrf.mrf_stack
                n0 = fn.launches
                with torch.no_grad():
                    if mode == "folded":
                        fold = 128 // C
                        got = fn(x.reshape(B, T // fold, fold * C), dict(st, fold=fold), ks,
                                 prefolded=True)
                    else:
                        got = fn(x, st, ks)
                    sync(torch)
                    n = mrf.stage_launches(C, len(ks), 3)
                    if fn.launches != n0 + n:
                        raise AssertionError(f"C={C} B={B}: {fn.__name__} launched "
                                             f"{fn.launches - n0} times, want {n}")
                    want = mrf.mrf_stack_plain(x, st, ks)
                name = fn.__name__
                rec = records["mrf_stage_narrow" if mrf.route(C) == "mrf_stage_narrow" else name]
                rec["err"] = max(rec["err"], check_close(
                    f"{name} C={C} (at {mrf.kernel_width(C)}) B={B} T={T} k={ks} (bf16)",
                    got, want, BF16_TOL))


def random_mrf(torch, C, kernel_sizes, g, n_pair=3):
    """Stacked fp32 MRF weights of one stage at width C from generator g,
    scaled like an initialised conv's (taps outside each k zero)."""
    n_br = len(kernel_sizes)
    w = torch.zeros(2, n_br, n_pair, 11, C, C, device=g.device)
    for br, k in enumerate(kernel_sizes):
        pad = (11 - k) // 2
        w[:, br, :, pad:pad + k] = torch.randn(2, n_pair, k, C, C, device=g.device,
                                               generator=g) * (k * C) ** -0.5
    b = torch.randn(2, n_br, n_pair, C, device=g.device, generator=g) * 0.1
    return {"w1": w[0].contiguous(), "w2": w[1].contiguous(), "b1": b[0].contiguous(),
            "b2": b[1].contiguous()}


def hifigan_v2_phase(torch, pre, cfg, model, vocoder, records):
    """Phase 19 (b): HiFi-GAN V2 (V2_CONFIG) from a seed, as `get_vocoder`
    builds it from a `config.json` beside a checkpoint directory without
    weights, vocoding phase 4's acoustic model: a B=1 request at bucket
    1000 (launches counted: V2_LAUNCHES, the folded entry point at every
    stage and `mrf_stack` none, of them `narrow_stage`'s one at each V2_NARROW
    stage), a small request against the CPU at phase 5's bars, its latency
    beside V1's, and each MRF call of one request at bucket 1000 against its
    plain version and timed, by kernel (the pair kernel at C = 64 and 32,
    `mrf_stack_folded_v2`; the narrow stages' kernel at 16 and 8,
    `mrf_stage_narrow`), beside the bound of each kernel's work and the
    request's MRF time beside V1's."""
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    from mixgantts_tpu_torch.ops import mrf
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    rec, narrow_rec = records["mrf_stack_folded_v2"], records["mrf_stage_narrow"]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(V2_CONFIG, f)
        v2 = get_vocoder(cfg, ckpt_dir=ckpt_dir, device=DEVICE, seed=0)
        gen = v2.generator
        log(f"[v2] HiFi-GAN V2: stages {[u.out_channels for u in gen.ups]}, "
            f"{sum(p.numel() for p in gen.parameters()) / 1e6:.2f} M parameters")
        pipe = TTSPipeline(model, v2, pre, cfg)
        one = text_batch(1, 64, 24, seed=0)
        pipe(one)
        mrf.narrow_stage.launches = 0
        (wavs, mel, lens), launches = counted(torch, lambda: pipe(one))
        narrow = mrf.narrow_stage.launches
        log(f"  B=1 request at bucket {mel.shape[1]}: launches (denoiser, mrf_stack, "
            f"mrf_stack_folded) {launches}, want {V2_LAUNCHES}; of them the narrow stages' "
            f"kernel {narrow}, want {len(V2_NARROW)}; mel length {int(lens[0])}")
        if launches != V2_LAUNCHES or narrow != len(V2_NARROW) or mel.shape[1] != 1000:
            raise AssertionError(f"the V2 request launched {launches} ({narrow} narrow) at "
                                 f"bucket {mel.shape[1]}")
        if not np_isfinite(mel) or len(wavs[0]) != int(lens[0]) * 256:
            raise AssertionError("the V2 request gave a bad output")
        rec["launches"] = launches[2] - narrow
        narrow_rec["launches"] = narrow
        cpu_reference(torch, pre, cfg, model, v2, label="v2", ckpt_dir=ckpt_dir)
    latency(torch, pipe, pre, one, None, tag="v2 latency")
    latency(torch, TTSPipeline(model, vocoder, pre, cfg), pre, one, None, tag="v1 latency")
    # the MRF calls of one request at bucket 1000, as in phase 6
    dils = gen.resblock_dilation_sizes[0]
    g = torch.Generator("cuda").manual_seed(20)
    work = {id(r): [0.0, 0.0, 0.0, 0.0] for r in (rec, narrow_rec)}   # ms, plain, FLOP, bytes
    with torch.no_grad():
        for stage, (C, T, call) in enumerate(mrf_calls(gen, gen.resblock_kernel_sizes, dils,
                                                        T_mel=1000)):
            x = torch.randn(1, T, C, device="cuda", generator=g)
            for name, st, ks, run in call:
                if name != "mrf_stack_folded":
                    raise AssertionError(f"V2 stage {stage} (C={C}) runs {name}")
                r = narrow_rec if mrf.route(C) == "mrf_stage_narrow" else rec
                r["err"] = max(r["err"], check_close(
                    f"V2 stage {stage} C={C} (at {mrf.kernel_width(C)}, {mrf.route(C)}) T={T} "
                    f"(bf16)", run(x), mrf.mrf_stack_plain(x, st, ks, dils), BF16_TOL))
                warm_up(lambda: run(x))
                t = time_ms(lambda: run(x), 10)
                p = time_ms(lambda: mrf.mrf_stack_plain(x, st, ks, dils), 3)
                f, b = mrf_work(1, T, C, ks, weight_bytes=2)
                log(f"  V2 stage {stage} C={C} T={T} ({mrf.route(C)}, "
                    f"{mrf.stage_launches(C, len(ks), len(dils))} launch(es)): kernel {t:.4f} ms, "
                    f"plain (bf16) {p:.4f} ms; {f / 1e9:.2f} GFLOP, {b / 1e6:.1f} MB, bound "
                    f"{bound_ms(f, b, PEAK_BF16_FLOPS)[0]:.4f} ms")
                w = work[id(r)]
                w[:] = [w[0] + t, w[1] + p, w[2] + f, w[3] + b]
    for r in (rec, narrow_rec):
        ms, plain, flops, nbytes = work[id(r)]
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        r.update(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
        log(f"  V2's MRF on {r['name']} per B=1 request at bucket 1000: {ms:.4f} ms, plain "
            f"{plain:.4f} ms; bound {bound:.4f} ms at bf16 ({by}) for {flops / 1e9:.1f} GFLOP")
    flops = sum(w[2] for w in work.values())
    nbytes = sum(w[3] for w in work.values())
    v1 = records["mrf_stack"]["ms"] + records["mrf_stack_folded"]["ms"]
    log(f"[v2] MRF per B=1 request at bucket 1000: {rec['ms'] + narrow_rec['ms']:.4f} ms (V1 "
        f"{v1:.4f} ms in phase 6); bound {bound_ms(flops, nbytes, PEAK_BF16_FLOPS)[0]:.4f} ms at "
        f"bf16 for {flops / 1e9:.1f} GFLOP")


def widths_phase(torch, pre, cfg, model, vocoder, records):
    """Phase 19: (a) `mrf_widths`; (b) `hifigan_v2_phase`; (c) the
    multi-device dryrun at the JAX dryrun's widths (denoiser 8, vocoder
    stages 8 and 4), rank 0's kernel launches read from its synthesis
    line; (d) `denoiser_widths` at WIDE_WIDTHS, and the time at C = 512
    (B=1, T=1000, 20 layers) beside the bound."""
    import re
    from mixgantts_tpu_torch.dryrun import dryrun_multigpu
    from mixgantts_tpu_torch.ops import denoiser_stack as den
    t_start = time.perf_counter()
    mrf_widths(torch, records)
    hifigan_v2_phase(torch, pre, cfg, model, vocoder, records)
    out = dryrun_multigpu(2, device="cuda", timeout=300)
    m = re.search(r"launches=\[(\d+), (\d+), (\d+)\]", out)
    launches = tuple(int(n) for n in m.groups()) if m else None
    log(f"[widths] (c) the dryrun at the JAX dryrun's widths: rank 0's synthesis launched "
        f"(denoiser, mrf_stack, mrf_stack_folded) {launches}")
    if not launches or not (launches[0] and launches[2]):
        raise AssertionError("the dryrun's synthesis did not launch the denoiser and the "
                             "folded MRF kernel")
    t_d = time.perf_counter()
    rec, wide = records["fused_residual_stack_c512"], records["fused_residual_stack_wide"]
    rec["launches"] = denoiser_widths(torch, rec, [c for c in WIDE_WIDTHS if not den.is_wide(c)],
                                      seed=19)
    wide["checked"] = denoiser_widths(torch, wide, [c for c in WIDE_WIDTHS if den.is_wide(c)],
                                      seed=19)
    ctas, cluster, resident = den.launch_shape(1, 1000, 512)
    log(f"  residual_stack_mma<512>: clusters of {cluster} CTAs, {resident} resident at once; "
        f"{ctas} CTAs at B=1, T=1000")
    if resident < 1:
        raise AssertionError("no cluster of the C=512 denoiser kernel fits the card")
    g = torch.Generator("cuda").manual_seed(21)
    for C in (512,) + WIDE_TIMED:
        kw = den.denoiser_kernel_weights(random_stack(torch, 20, C, 256, g))
        got = time_denoiser(torch, "fused_residual_stack", 1, 1000, kw)
        if C in (512, WIDE_MODEL_CHANNELS):
            records["fused_residual_stack_c512" if C == 512 else "fused_residual_stack_wide"].update(
                zip(("ms", "plain_ms", "bound_ms", "bound_by"), got))
        del kw
    t_e = time.perf_counter()
    wide_model_phase(torch, pre, cfg, vocoder, wide)
    log(f"[widths] phase 19 took {time.perf_counter() - t_start:.1f} s: (d) {t_e - t_d:.1f} s, "
        f"(e) {time.perf_counter() - t_e:.1f} s")


def wide_model_phase(torch, pre, cfg, vocoder, rec):
    """Phase 19 (e): phase 4's LJSpeech acoustic model with the denoiser at
    WIDE_MODEL_CHANNELS residual channels (20 layers, the wide route) from
    a seed, vocoded by phase 4's HiFi-GAN V1: a B=1 request at bucket 1000
    must launch the denoiser 40 times (two a layer) and the MRF kernels 18
    and 18; a small request against the CPU at phase 5's bars
    (`cpu_reference`); its latency."""
    import copy
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    wide_cfg = copy.deepcopy(cfg)
    wide_cfg["denoiser"]["residual_channels"] = WIDE_MODEL_CHANNELS
    model = build_acoustic(torch, pre, wide_cfg, DEVICE)
    log(f"[wide] the LJSpeech model at residual_channels {WIDE_MODEL_CHANNELS}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters")
    pipe = TTSPipeline(model, vocoder, pre, wide_cfg)
    one = text_batch(1, 64, 24, seed=0)
    pipe(one)
    (wavs, mel, lens), launches = counted(torch, lambda: pipe(one))
    want = (2 * cfg["denoiser"]["residual_layers"],) + REQUEST_LAUNCHES[(1, 1000)][1:]
    log(f"  B=1 request at bucket {mel.shape[1]}: launches (denoiser, mrf_stack, "
        f"mrf_stack_folded) {launches}, want {want}; mel length {int(lens[0])}")
    if launches != want or mel.shape[1] != 1000:
        raise AssertionError(f"the wide denoiser's request launched {launches} at bucket "
                             f"{mel.shape[1]}")
    if not np_isfinite(mel) or len(wavs[0]) != int(lens[0]) * 256:
        raise AssertionError("the wide denoiser's request gave a bad output")
    rec["launches"] = launches[0]
    cpu_reference(torch, pre, wide_cfg, model, vocoder, label=f"denoiser {WIDE_MODEL_CHANNELS}")
    latency(torch, pipe, pre, one, None, tag=f"denoiser {WIDE_MODEL_CHANNELS} latency")


def mrf_checked(torch, rec, label, fn, run, x, st, ks, ds, launches):
    """run() on the card must raise fn's launch count by `launches` and
    agree with the bf16 plain version at BF16_TOL (the error and the
    launches go into rec)."""
    from mixgantts_tpu_torch.ops import mrf
    n0 = fn.launches
    with torch.no_grad():
        got = run()
        sync(torch)
        if fn.launches - n0 != launches:
            raise AssertionError(f"{label}: {fn.__name__} launched {fn.launches - n0} times, "
                                 f"want {launches}")
        want = mrf.mrf_stack_plain(x, st, ks, ds)
    rec["checked"] += launches
    rec["err"] = max(rec["err"], check_close(label, got, want, BF16_TOL))


def mrf_shape_checks(torch, records):
    """Phase 20 (a): every new shape of the MRF kernels against its bf16
    plain version at SHAPE_FRAMES, the launch counts rising at each call:
    `mrf_stack` above 256 (WIDE_MRF_WIDTHS, one branch a call, run at 512:
    two launches a pair), at MRF_SHAPES' kernel sizes and schedules at
    MRF_SHAPE_WIDTHS, the folded entry point at those shapes (C = 64 on the
    pair kernel, C = 16 on the narrow stages' kernel, whose error goes to
    its record), and `mrf_stack_streamed` at STREAMED_WIDTHS and
    STREAMED_SHAPES."""
    from mixgantts_tpu_torch.ops import mrf
    g = torch.Generator("cuda").manual_seed(20)
    wide, shapes, streamed, narrow = (records[n] for n in (
        "mrf_stack_c512", "mrf_stack_shapes", "mrf_stack_streamed_c512", "mrf_stage_narrow"))
    for B, T in SHAPE_FRAMES:
        for C in WIDE_MRF_WIDTHS:
            x = torch.randn(B, T, C, device="cuda", generator=g)
            for ks in ((3,), (7,), (11,)):
                st = mrf.kernel_weights(random_mrf(torch, C, ks, g), ks)
                mrf_checked(torch, wide, f"mrf_stack C={C} (at 512) B={B} T={T} k={ks} (bf16)",
                            mrf.mrf_stack, lambda: mrf.mrf_stack(x, st, ks), x, st, ks,
                            (1, 3, 5), 6)
        for C in MRF_SHAPE_WIDTHS:
            x = torch.randn(B, T, C, device="cuda", generator=g)
            for ks, ds in MRF_SHAPES:
                st = mrf.kernel_weights(random_mrf(torch, C, ks, g, len(ds)), ks)
                mrf_checked(torch, shapes, f"mrf_stack C={C} B={B} T={T} k={ks} d={ds} (bf16)",
                            mrf.mrf_stack, lambda: mrf.mrf_stack(x, st, ks, ds), x, st, ks, ds,
                            len(ks) * len(ds) * mrf.pair_launches(C))
        for C in (64, 16):
            fold = 128 // C
            x = torch.randn(B, T, C, device="cuda", generator=g)
            for ks, ds in MRF_SHAPES:
                st = dict(mrf.kernel_weights(random_mrf(torch, C, ks, g, len(ds)), ks), fold=fold)
                mrf_checked(torch, narrow if mrf.route(C) == "mrf_stage_narrow" else shapes,
                            f"mrf_stack_folded C={C} (F={fold}, {mrf.route(C)}) B={B} T={T} "
                            f"k={ks} d={ds} (bf16)",
                            mrf.mrf_stack_folded, lambda: mrf.mrf_stack_folded(
                                x.reshape(B, T // fold, fold * C), st, ks, ds, prefolded=True),
                            x, st, ks, ds, mrf.stage_launches(C, len(ks), len(ds)))
        for C in STREAMED_WIDTHS:
            x = torch.randn(B, T, C, device="cuda", generator=g)
            for ks, ds in STREAMED_SHAPES:
                st = mrf.kernel_weights(random_mrf(torch, C, ks, g, len(ds)), ks)
                mrf_checked(torch, streamed,
                            f"mrf_stack_streamed C={C} (at {mrf.streamed_width(C)}) B={B} T={T} "
                            f"k={ks} d={ds} (bf16)",
                            mrf.mrf_stack_streamed, lambda: mrf.mrf_stack_streamed(x, st, ks, ds),
                            x, st, ks, ds, 1)
    for C in mrf.STREAMED_WIDTHS:   # and the in-place plan's edge at 512: reaches 43 and 44
        for ks, ds in STREAMED_SHAPES + (((3,), (43,)), ((3,), (44,))):
            plan = mrf.streamed_plan(1, 8000, ks, ds, C=C)
            log(f"  mrf_stack_streamed C={C} k={ks} d={ds}: passes of {plan['rows']} rows, "
                f"{plan['stages']} ring stages, y {'out of' if plan['pingpong'] else 'in'} "
                f"place, {plan['smem']} B of shared memory per CTA")


def timed_mrf(torch, label, calls, B, T, C, ks_list, plain_iters=2):
    """Device time of a list of MRF calls (fn(), plain()) on one input, in
    turns (kernel, plain, kernel), beside the bound of the work at the bf16
    peak: (ms, plain_ms, bound_ms, bound_by)."""
    run = lambda: [fn() for fn, _ in calls]
    warm_up(run)
    ms1 = time_ms(run, 5)
    plain = time_ms(lambda: [p() for _, p in calls], plain_iters)
    ms2 = time_ms(run, 5)
    flops = nbytes = 0
    for ks, n_pair in ks_list:
        f, b = mrf_work(B, T, C, ks, n_pair, weight_bytes=2)
        flops, nbytes = flops + f, nbytes + b
    bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    ms = (ms1 + ms2) / 2
    log(f"  {label}: kernel {ms1:.4f}/{ms2:.4f} ms, plain (bf16) {plain:.4f} ms, bound "
        f"{bound:.4f} ms at bf16 ({by}) for {flops / 1e9:.1f} GFLOP; "
        f"{flops / ms / 1e9:.1f} TFLOP/s ({100 * flops / ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1f}% "
        f"of the bf16 peak)")
    return ms, plain, bound, by


def shape_timings(torch, records):
    """Phase 20 (c): the time of each new kernel shape at B=1, T=8000:
    the C=512 stage in `mrf_stack` (one call per branch) and in
    `mrf_stack_streamed`, MRF_SHAPES at C=256, and STREAMED_SHAPES at 512."""
    from mixgantts_tpu_torch.ops import mrf
    g = torch.Generator("cuda").manual_seed(22)
    B, T = SHAPE_FRAMES[0]
    rks, dils = (3, 7, 11), (1, 3, 5)
    with torch.no_grad():
        x = torch.randn(B, T, 512, device="cuda", generator=g)
        branches = [(mrf.kernel_weights(random_mrf(torch, 512, (k,), g), (k,)), (k,)) for k in rks]
        calls = [(lambda st=st, ks=ks: mrf.mrf_stack(x, st, ks),
                  lambda st=st, ks=ks: mrf.mrf_stack_plain(x, st, ks)) for st, ks in branches]
        ms, plain, b, by = timed_mrf(torch, f"mrf_stack C=512 stage B={B} T={T} (three "
                                     "one-branch calls, 18 launches)", calls, B, T, 512,
                                     [((k,), 3) for k in rks])
        records["mrf_stack_c512"].update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
        whole = mrf.kernel_weights(random_mrf(torch, 512, rks, g), rks)
        ms, plain, b, by = timed_mrf(
            torch, f"mrf_stack_streamed C=512 stage B={B} T={T} (one launch)",
            [(lambda: mrf.mrf_stack_streamed(x, whole), lambda: mrf.mrf_stack_plain(x, whole))],
            B, T, 512, [(rks, 3)])
        records["mrf_stack_streamed_c512"].update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
        x = torch.randn(B, T, 256, device="cuda", generator=g)
        for i, (ks, ds) in enumerate(MRF_SHAPES):
            st = mrf.kernel_weights(random_mrf(torch, 256, ks, g, len(ds)), ks)
            got = timed_mrf(torch, f"mrf_stack C=256 B={B} T={T} k={ks} d={ds}",
                            [(lambda: mrf.mrf_stack(x, st, ks, ds),
                              lambda: mrf.mrf_stack_plain(x, st, ks, ds))],
                            B, T, 256, [(ks, len(ds))])
            if i == 0:
                records["mrf_stack_shapes"].update(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                                                       got))
        x = torch.randn(B, T, 512, device="cuda", generator=g)
        for ks, ds in STREAMED_SHAPES[1:]:
            st = mrf.kernel_weights(random_mrf(torch, 512, ks, g, len(ds)), ks)
            timed_mrf(torch, f"mrf_stack_streamed C=512 B={B} T={T} k={ks} d={ds}",
                      [(lambda: mrf.mrf_stack_streamed(x, st, ks, ds),
                        lambda: mrf.mrf_stack_plain(x, st, ks, ds))], B, T, 512, [(ks, len(ds))])


def hifigan_1024_phase(torch, pre, cfg, model, records):
    """Phase 20 (b): HiFi-GAN V1 at upsample_initial_channel 1024
    (V1_1024_CONFIG: stages 512, 256, 128, 64) from a seed, as `get_vocoder`
    builds it from a `config.json`, vocoding phase 4's acoustic model: a
    B=1 request at bucket 1000 (launches counted: the denoiser once,
    `mrf_stack` 36 times, 18 of them at 512, and the folded kernel 9), a
    small request against the CPU at phase 5's bars (`check_against_cpu`),
    its latency, and each MRF call of the request against its plain
    version, timed, beside the bound of the request's MRF work."""
    from mixgantts_tpu_torch.models.vocoder import get_vocoder
    from mixgantts_tpu_torch.ops import mrf
    from mixgantts_tpu_torch.pipeline import TTSPipeline
    rec = records["mrf_stack_c512"]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(V1_1024_CONFIG, f)
        voc = get_vocoder(cfg, ckpt_dir=ckpt_dir, device=DEVICE, seed=0)
        gen = voc.generator
        log(f"[1024] HiFi-GAN V1 at upsample_initial_channel 1024: stages "
            f"{[u.out_channels for u in gen.ups]}, "
            f"{sum(p.numel() for p in gen.parameters()) / 1e6:.2f} M parameters")
        pipe = TTSPipeline(model, voc, pre, cfg)
        one = text_batch(1, 64, 24, seed=0)
        pipe(one)
        (wavs, mel, lens), launches = counted(torch, lambda: pipe(one))
        log(f"  B=1 request at bucket {mel.shape[1]}: launches (denoiser, mrf_stack, "
            f"mrf_stack_folded) {launches}, want (1, 36, 9); mel length {int(lens[0])}")
        if launches != (1, 36, 9) or mel.shape[1] != 1000:
            raise AssertionError(f"the 1024 request launched {launches} at bucket "
                                 f"{mel.shape[1]}")
        if not np_isfinite(mel) or len(wavs[0]) != int(lens[0]) * 256:
            raise AssertionError("the 1024 request gave a bad output")
        rec["launches"] = launches[1]
        cpu_reference(torch, pre, cfg, model, voc, label="v1 1024", ckpt_dir=ckpt_dir)
    latency(torch, pipe, pre, one, None, tag="v1 1024 latency")
    dils = gen.resblock_dilation_sizes[0]
    g = torch.Generator("cuda").manual_seed(21)
    ms = flops = nbytes = 0.0
    with torch.no_grad():
        for stage, (C, T, call) in enumerate(mrf_calls(gen, gen.resblock_kernel_sizes, dils,
                                                        T_mel=1000)):
            x = torch.randn(1, T, C, device="cuda", generator=g)
            for name, st, ks, run in call:
                err = check_close(f"1024 vocoder stage {stage} C={C} T={T} {name} k={ks} (bf16)",
                                  run(x), mrf.mrf_stack_plain(x, st, ks, dils), BF16_TOL)
                if C > mrf.SPLIT:
                    rec["err"] = max(rec["err"], err)
                warm_up(lambda: run(x), 0.2)
                t = time_ms(lambda: run(x), 10)
                f, b = mrf_work(1, T, C, ks, weight_bytes=2)
                log(f"  1024 vocoder stage {stage} C={C} T={T} {name} k={ks}: kernel {t:.4f} ms, "
                    f"bound {bound_ms(f, b, PEAK_BF16_FLOPS)[0]:.4f} ms ({f / 1e9:.1f} GFLOP)")
                ms, flops, nbytes = ms + t, flops + f, nbytes + b
    bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"[1024] MRF per B=1 request at bucket 1000: {ms:.4f} ms; bound {bound:.4f} ms at bf16 "
        f"({by}) for {flops / 1e9:.1f} GFLOP")


def shapes_phase(torch, pre, cfg, model, records):
    """Phase 20: (a) `mrf_shape_checks`; (b) `hifigan_1024_phase`; (c)
    `shape_timings`."""
    t_start = time.perf_counter()
    mrf_shape_checks(torch, records)
    hifigan_1024_phase(torch, pre, cfg, model, records)
    shape_timings(torch, records)
    for name in ("mrf_stack_shapes", "mrf_stack_streamed_c512"):
        records[name]["launches"] = records[name]["checked"]
    log(f"[shapes] phase 20 took {time.perf_counter() - t_start:.1f} s")


def main():
    if sys.argv[1:2] == ["--train-cli-rank"]:   # a torchrun rank of phase 16 (c)
        train_cli_rank(sys.argv[2], sys.argv[3:])
        return 0
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace one B=1 request into DIR, and keep phases 10-14's "
                             "traces there")
    # a rank of phase 16's multi-process steps (started by the script itself)
    parser.add_argument("--multi-worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--workdir", help=argparse.SUPPRESS)
    parser.add_argument("--init", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.multi_worker:
        multi_rank_worker(args)
        return 0
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
                                      "mixgantts_tpu/ops/pallas_vocoder.py:461"),
               "fused_residual_stack_c16": ("mixgantts_tpu_torch/csrc/denoiser_stack.cu",
                                            "mixgantts_tpu/ops/pallas.py:122"),
               "mrf_stack_folded_v2": ("mixgantts_tpu_torch/csrc/mrf_stack.cu",
                                       "mixgantts_tpu/ops/pallas_vocoder.py:303"),
               "mrf_stage_narrow": ("mixgantts_tpu_torch/csrc/mrf_stage_narrow.cu",
                                    "mixgantts_tpu/ops/pallas_vocoder.py:303"),
               "fused_residual_stack_c512": ("mixgantts_tpu_torch/csrc/denoiser_stack.cu",
                                             "mixgantts_tpu/ops/pallas.py:122"),
               "fused_residual_stack_wide": ("mixgantts_tpu_torch/csrc/denoiser_stack.cu",
                                             "mixgantts_tpu/ops/pallas.py:122"),
               "mrf_stack_c512": ("mixgantts_tpu_torch/csrc/mrf_stack.cu",
                                  "mixgantts_tpu/ops/pallas_vocoder.py:528"),
               "mrf_stack_shapes": ("mixgantts_tpu_torch/csrc/mrf_stack.cu",
                                    "mixgantts_tpu/ops/pallas_vocoder.py:528"),
               "mrf_stack_streamed_c512": ("mixgantts_tpu_torch/csrc/mrf_stack_streamed.cu",
                                           "mixgantts_tpu/ops/pallas_vocoder.py:461")}
    records = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "err": 0.0, "checked": 0}
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
        plain = training_phase(torch, args.profile or tmp)        # phase 12
        log("[train cli] the train CLI at full width: aux, the aux -> shallow handoff, "
            "resume")
        train_cli_phase(torch)                                    # phase 13
        log("[train variants] reuse_g_forward, reuse_aux_forward and bf16 compute at full "
            "width")
        t0 = time.perf_counter()
        train_variants_phase(torch, args.profile or tmp, plain)   # phase 14
        log(f"[train variants] phase 14 took {time.perf_counter() - t0:.1f} s")
    log("[prep] raw corpus -> prepare_align -> preprocess -> the train CLI, LJSpeech and "
        "AISHELL3")
    t0 = time.perf_counter()
    preprocessing_phase(torch)                                    # phase 15
    log(f"[prep] phase 15 took {time.perf_counter() - t0:.1f} s")
    log("[multi] the multi-device path: data and tensor parallel steps, the train CLI under "
        "torchrun, sharded serving, the dryrun")
    multi_device_phase(torch, pre, cfg, model, vocoder, records)  # phase 16
    log(f"[bench] the port's benchmark and measuring tools; {gpu}")
    bench_phase(torch, pre, cfg, model, vocoder, records)         # phase 17
    log("[horizon] the denoiser kernel below C=256, and the long-horizon drive's stages")
    horizon_phase(torch, records)                                 # phase 18
    log("[widths] the MRF kernels at every width up to 256, HiFi-GAN V2, the dryrun at the "
        "JAX dryrun's widths, the denoiser above 256 and above 512, the acoustic model at "
        f"residual_channels {WIDE_MODEL_CHANNELS}")
    widths_phase(torch, pre, cfg, model, vocoder, records)        # phase 19
    log("[shapes] the MRF kernels at every shape the TPU kernels take: widths up to 512, "
        "every odd k, every schedule within the halo; HiFi-GAN V1 at 1024 channels")
    shapes_phase(torch, pre, cfg, model, records)                 # phase 20

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
