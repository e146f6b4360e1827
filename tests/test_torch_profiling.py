"""The port's profiling (`mixgantts_tpu_torch/utils/profiling.py`) on the
CPU, the counterparts of `tests/test_profiling.py`: `trace` writes a
torch.profiler trace file (TensorBoard's `*.pt.trace.json`), the
`StepProfiler` window writes one and is a no-op without a directory, and
the throughput meter's arithmetic; the window opens and closes at the
steps the JAX package's `StepProfiler` does (its `>=` rule over chunked
step jumps, compared call by call); `start_server` arms a window over
HTTP on localhost.
"""

import glob
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mixgantts_tpu.utils import profiling as jprofiling
from mixgantts_tpu_torch.utils import profiling
from mixgantts_tpu_torch.utils.profiling import StepProfiler, ThroughputMeter, start_server, trace


def traces(log_dir):
    return glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True)


def test_trace_context_writes_profile(tmp_path):
    log_dir = str(tmp_path / "prof")
    with trace(log_dir):
        x = torch.ones(64, 64)
        (x @ x).sum().item()
    assert traces(log_dir)


def test_step_profiler_window(tmp_path):
    log_dir = str(tmp_path / "prof")
    prof = StepProfiler(log_dir, start_step=3, n_steps=2)
    for step in range(1, 7):
        prof.step(step)
        (torch.ones(8, 8) * step).sum().item()
    prof.close()
    assert traces(log_dir)


def test_step_profiler_noop_without_dir():
    prof = StepProfiler(None, start_step=0)
    for step in range(3):
        prof.step(step)
    prof.close()


def test_throughput_meter():
    m = ThroughputMeter()
    m.update(np.array([10, 20]))
    m.update(np.array([5, 5]))
    it_s, frames_s = m.read_and_reset()
    assert it_s > 0 and frames_s > 0
    assert abs(frames_s / it_s - 20.0) < 1e-6  # 40 frames / 2 steps


class Recorder:
    """Stands in for a trace: records start and stop with the step."""

    def __init__(self, events, step):
        self.events, self.step = events, step

    def start(self):
        self.events.append(("start", self.step[0]))

    def stop(self):
        self.events.append(("stop", self.step[0]))


@pytest.mark.parametrize("start,steps", [(3, range(1, 12)), (5, range(1, 30, 4)),
                                         (2, range(6, 20, 8))], ids=["k1", "k4", "jump"])
def test_window_matches_jax(monkeypatch, start, steps):
    """The steps at which each package starts and stops its trace, over
    steps advancing by 1, in chunks of 4, and jumping over the window."""
    step, want, got = [0], [], []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: want.append(("start", step[0])))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: want.append(("stop", step[0])))
    monkeypatch.setattr(profiling, "_profiler", lambda d: Recorder(got, step))
    jprof, prof = jprofiling.StepProfiler("j", start, 5), StepProfiler("t", start, 5)
    for s in steps:
        step[0] = s
        jprof.step(s)
        prof.step(s)
    jprof.close()
    prof.close()
    assert got == want and got


def test_server_arms_a_window(tmp_path):
    log_dir = str(tmp_path / "armed")
    prof = StepProfiler(None, start_step=0)
    server = start_server(0, prof, default_dir=str(tmp_path / "default"))
    try:
        port = server.server_address[1]
        direct = urllib.request.build_opener(urllib.request.ProxyHandler({}))   # no proxy
        with direct.open(f"http://localhost:{port}/?steps=2&dir={log_dir}") as r:
            assert r.status == 200 and b"armed: 2 steps" in r.read()
    finally:
        server.shutdown()
    for step in range(10, 14):
        prof.step(step)
        (torch.ones(8, 8) * step).sum().item()
    prof.close()
    assert traces(log_dir) and not os.path.exists(str(tmp_path / "default"))
