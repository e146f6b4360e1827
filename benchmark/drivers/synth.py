"""Batch synthesis through `TTSPipeline`: a closed loop, one client and
one call in flight, `batch` sentences a call through `submit` then
`collect`, as batch synthesis (audiobooks, corpus generation) sends them.
(The synthesis CLI's `TTSPipeline.stream` keeps two in flight, which reads
slower on one stream: `collect` of call N waits behind call N+1.)

End to end (host clock): `utt_per_s`, utterances whose waveforms reached
the host in the window over the time from its first submit to its last
collect; `synth_p95_ms`, the 95th percentile over the window's calls of
submit until the end of `collect`'s copy.

What the timed path produced is held against the reference on a sample of
the window's calls drawn from the seed (with the first that holds the
traffic's longest sentence): forward hooks that only keep references to
the program's outputs (its encoder features, coarse mel, mel and its
discrete decisions) for those calls, and the int16 waveforms `collect`
returned.
"""

import time

import numpy as np
import torch

from .. import core, traffic as T
from ..checks import SynthOutputs, judge_synth


def longest(batch):
    return int(batch["src_lens"].max())


def call_seed(seed, i):
    return core.sub_seed(seed, "noise", i)


class Capture:
    """Forward hooks on the model and its encoder that keep the program's
    outputs of the calls marked `keep`, and its decisions for every call."""

    def __init__(self, model):
        self.keep = False
        self.index = 0
        self.calls = {}
        self.handles = [model.linguistic_encoder.register_forward_hook(self._encoder),
                        model.register_forward_hook(self._model)]

    def _encoder(self, module, args, out):
        if self.keep:
            self.calls.setdefault(self.index, {})["features"] = out.features

    def _model(self, module, args, out):
        entry = self.calls.setdefault(self.index, {})
        entry.update(pitch=out.pitch_pred, energy=out.energy_pred, dur_w=out.dur_w_rounded)
        if self.keep:
            entry.update(coarse=out.coarse_mel, mel=out.mel_pred)

    def remove(self):
        for h in self.handles:
            h.remove()


class Timing:
    """The traced run's hooks: CUDA events at the acoustic model's and the
    vocoder's forward, and profiler spans around them."""

    def __init__(self, model, vocoder_module):
        self.events = {"acoustic": [], "vocoder": []}
        self.spans = {}
        self.handles = []
        for name, m in (("acoustic", model), ("vocoder", vocoder_module)):
            self.handles.append(m.register_forward_pre_hook(self._pre(name)))
            self.handles.append(m.register_forward_hook(self._post(name)))

    def _pre(self, name):
        def hook(module, args):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events[name].append([start, None])
            self.spans[name] = torch.autograd.profiler.record_function(name)
            self.spans[name].__enter__()
        return hook

    def _post(self, name):
        def hook(module, args, out):
            self.spans.pop(name).__exit__(None, None, None)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events[name][-1][1] = end
        return hook

    def ms(self, name, calls):
        return [self.events[name][i][0].elapsed_time(self.events[name][i][1]) for i in calls]

    def remove(self):
        for h in self.handles:
            h.remove()


def run(ctx):
    cfg, spec, device = ctx.config, ctx.traffic, ctx.device
    pipeline, model, vocoder, weights = core.program_synth(cfg, device, core.sub_seed(ctx.seed, "w"))
    core.log(f"set-up {ctx.clock():.2f} s: the program built, the weights loaded")
    n_symbols = cfg["n_symbols"]
    pool_longest = max(sum(s) for t in T.synth_templates(spec) for s in t)

    # warm up the shapes of this stream, one template of each, `warm_rounds` times
    warm = core.rng(ctx.seed, "warm")
    shapes = {}
    for sentences in T.synth_templates(spec):
        shapes.setdefault(batch_shape(cfg, T.synth_batch(sentences, warm, n_symbols, 0)),
                          sentences)
    for _ in range(spec["warm_rounds"]):
        for sentences in shapes.values():
            batch = T.synth_batch(sentences, warm, n_symbols, 0)
            pipeline.collect(pipeline.submit(batch, generator=torch.Generator(device).manual_seed(
                core.sub_seed(ctx.seed, "warm-noise"))))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    core.log(f"set-up {ctx.clock():.2f} s: warmed up")

    capture = Capture(model)
    timing = Timing(model, vocoder.generator) if ctx.trace else None
    sample_draw = core.rng(ctx.seed, "sample")
    stream = T.synth_stream(spec, ctx.seed, n_symbols, core.n_speakers(cfg))
    calls, batches, wavs, kept = [], [], {}, []
    longest_kept = False
    profiler, profiled = None, []
    setup_s = ctx.begin_window()
    start = time.perf_counter()
    while True:
        i = len(calls)
        batch = next(stream)
        keep = sample_draw.random() < spec["sample_rate"] and len(kept) < spec["sample_max"]
        if not longest_kept and longest(batch) == pool_longest:
            keep = longest_kept = True
        capture.keep, capture.index = keep, i
        g = torch.Generator(device).manual_seed(call_seed(ctx.seed, i))
        t0 = time.perf_counter()
        with ctx.span("submit"):
            pending = pipeline.submit(batch, generator=g)
        t1 = time.perf_counter()
        with ctx.span("collect"):
            out_wavs, _, mel_lens = pipeline.collect(pending)
        t2 = time.perf_counter()
        calls.append((t0, t1, t2, len(out_wavs)))
        batches.append(batch)
        if keep:
            kept.append(i)
            wavs[i] = (out_wavs, mel_lens)
        # a traced run profiles `profile_calls` calls from a call boundary
        if profiler is not None:
            profiled.append(i)
            if len(profiled) == spec["profile_calls"]:
                ctx.stop_profiler(profiler)
                profiler = None
        elif ctx.trace and not profiled and t2 - start >= spec["profile_after"] * ctx.seconds:
            profiler = ctx.start_profiler()
        if t2 - start >= ctx.seconds and profiler is None:
            break
    window = calls[-1][2] - calls[0][0]
    latencies = [c[2] - c[0] for c in calls]
    utts = sum(c[3] for c in calls)
    e2e = {"setup_s": setup_s, "utt_per_s": utts / window,
           "synth_p95_ms": 1e3 * float(np.percentile(latencies, 95))}
    core.log(f"window {window:.3f} s, {len(calls)} calls; latency ms p5/p50/p95/max "
             + "/".join(f"{1e3 * float(np.percentile(latencies, q)):.2f}" for q in (5, 50, 95, 100))
             + f"; submit ms mean {1e3 * np.mean([c[1] - c[0] for c in calls]):.2f}")

    readings = None
    if ctx.trace:
        outside = [j for j in range(len(calls)) if j not in profiled]
        readings = {"kind": "synth", "profiled": profiled, "outside": outside,
                    "shapes": [batch_shape(cfg, b) for b in batches],
                    "enqueue_ms": [1e3 * (calls[j][1] - calls[j][0]) for j in outside],
                    "acoustic_ms": timing.ms("acoustic", outside),
                    "vocoder_ms": timing.ms("vocoder", outside),
                    "call_s": [latencies[j] for j in outside],
                    "batch": spec["batch"]}
        timing.remove()
    capture.remove()
    device_info = ctx.read_device()

    # the program's state goes; then the reference judges the sample
    outputs = [SynthOutputs(batches[j], call_seed(ctx.seed, j), capture.calls[j], *wavs[j])
               for j in kept]
    del pipeline, model, vocoder, capture
    ctx.free()
    checks = judge_synth(cfg, weights, outputs, device, ctx.arith)
    if readings is not None:
        readings["work"] = synth_work(cfg, set(readings["shapes"]), spec["batch"])
    attempted = spec["batch"] * len(calls)
    return {"e2e": e2e, "readings": readings, "checks": checks, "device": device_info,
            "attempted": attempted, "failed": attempted - utts}


def batch_shape(config, batch):
    buckets = config["model"]["tpu"]["phone_buckets"]
    P = core.bucket(batch["texts"].shape[1], buckets)
    W = core.bucket(batch["word_boundaries"].shape[1], buckets)
    return P, W, core.frame_bucket(config, batch["texts"].shape[1])


def synth_work(config, shapes, B):
    """{shape: {"least_s": the call's least time at its stated types'
    peaks, "denoiser", "mrf": the kernels' work}} for each distinct
    (phone slots, word slots, frames)."""
    from ..work.counts import kernel_parts, least_call_s, synth_flops
    return {(P, W, T_): {"least_s": least_call_s(*synth_flops(config, B, P, W, T_)),
                         **kernel_parts(config, B, T_)} for P, W, T_ in shapes}
