"""Profiling and tracing (`mixgantts_tpu/utils/profiling.py`) on
`torch.profiler`: device traces (CPU and CUDA activities) written as
TensorBoard trace files (`tensorboard_trace_handler`, `*.pt.trace.json`,
also readable by Perfetto and chrome://tracing), and the training loop's
step-time and mel-frames/s counters.

Usage from the train CLI:
    --profile_dir DIR    trace a few steady-state steps into DIR (each rank
                         of a data-parallel run into DIR/rank<r>)
    --profile_port N     serve on-demand captures: an HTTP request to
                         http://localhost:N/?steps=K&dir=DIR arms a window
                         of K steps into DIR (torch has no live profiler
                         server; TensorBoard's capture button does not
                         speak to this one)

Spans: `span(name)` marks a part of the program as a `record_function`
range while a torch profiler runs, so the part's host time, and the
kernels and copies it launches, carry the name in the same trace (the
train CLI's `--profile_dir` / `--profile_port` captures included).  With
no profiler running a span costs one check and records nothing.  Names
(dotted, nested as listed):
    pipeline.submit, pipeline.collect   `TTSPipeline.submit` / `collect`
      model.encoder, model.decoder,     the linguistic encoder; the decoder
      model.postnet, model.diffusion    and mel_linear; the PostNet; the
                                        diffusion branch (also in training)
        encoder.capture, encoder.replay the encoder's CUDA graph: its capture
                                        (a key's second call) and each
                                        replay, with the copies in and the
                                        clones out
        diffusion.step                  one reverse step of inference: the
                                        denoiser, the clamp and the
                                        posterior sample (one a shallow
                                        call, `timesteps` a naive one)
      vocoder.upsample, vocoder.mrf     each HiFi-GAN stage's upsampling
                                        and MRF (layout changes included)
        kernel.fused_residual_stack, kernel.mrf_stack,
        kernel.mrf_stack_folded, kernel.mrf_stack_streamed,
        kernel.narrow_stage             each kernel entry, casts and
                                        padding included (the plain
                                        versions on the CPU too)
    train.step                          one train step (`make_train_step`)
      train.d_phase, train.g_phase      D's and G's update
        train.forward                   a generator forward
        train.losses                    D's loss; G's adversarial and
                                        reconstruction losses
        train.backward                  each `.backward()`, with the
                                        launches autograd makes meanwhile
        train.update                    each optimizer update (clipping,
                                        Adam)
    data.to_device                      `cli.common.to_device`: pinning
                                        and the copy
"""

import contextlib
import http.server
import os
import threading
import time
import urllib.parse

import numpy as np
import torch


_OFF = contextlib.nullcontext()


def span(name):
    """A context manager that marks the block as span `name` in a running
    torch profiler's trace (`record_function`), and does nothing when no
    profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _OFF


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _profiler(log_dir):
    os.makedirs(log_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir):
    """Trace the block into `log_dir` (a TensorBoard trace file)."""
    prof = _profiler(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


class StepProfiler:
    """Decides which steps fall inside the capture window and wraps them in
    a trace; a no-op when `log_dir` is None.  `arm` opens a new window of n
    steps from the next step (the `start_server` captures)."""

    def __init__(self, log_dir, start_step, n_steps=5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + n_steps
        self._prof = None
        self._done = False
        self._armed = None
        self._lock = threading.Lock()

    def arm(self, n_steps, log_dir):
        """Capture the next `n_steps` steps into `log_dir` (from another
        thread, too)."""
        with self._lock:
            self._armed = (int(n_steps), log_dir)

    def step(self, step):
        with self._lock:
            armed, self._armed = self._armed, None
        if armed is not None and self._prof is None:
            self.log_dir, self.start, self.stop = armed[1], step, step + armed[0]
            self._done = False
        if self.log_dir is None or self._done:
            return
        # >= comparisons: with k-step chunked dispatch the observed step
        # values advance in jumps and may never equal start/stop exactly;
        # a segment can even jump clean over [start, stop), so the start
        # condition is plain `step >= start` (the trace then covers the
        # next segment instead of silently never starting)
        if step >= self.stop and self._prof is not None:
            self.close()
            self._done = True
            print(f"profiler: trace written to {self.log_dir}")
        elif step >= self.start and self._prof is None:
            self._prof = _profiler(self.log_dir)
            self._prof.start()
            print(f"profiler: tracing steps >= {step} -> {self.log_dir}")

    def close(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
        n = int(q.get("steps", ["5"])[0])
        log_dir = q.get("dir", [self.server.default_dir])[0]
        self.server.profiler.arm(n, log_dir)
        body = f"armed: {n} steps -> {log_dir}\n".encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def start_server(port, profiler, default_dir="profile"):
    """An HTTP server on localhost:`port` in a daemon thread: a GET
    `/?steps=K&dir=DIR` arms `profiler` (a `StepProfiler`) for a window of
    K steps into DIR (default `default_dir`), the on-demand capture that
    JAX's profiler server gives TensorBoard.  Returns the server
    (`shutdown()` stops it)."""
    server = http.server.ThreadingHTTPServer(("localhost", int(port)), _Handler)
    server.profiler, server.default_dir = profiler, default_dir
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


class ThroughputMeter:
    """it/s and mel frames/s on the host clock between log points (the
    reference prints only it/s, `train.py:189-199`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._steps = 0
        self._frames = 0

    def update(self, mel_lens):
        self._steps += 1
        self._frames += int(np.sum(np.asarray(mel_lens)))

    def read_and_reset(self):
        dt = max(time.time() - self._t0, 1e-9)
        out = (self._steps / dt, self._frames / dt)
        self.reset()
        return out
