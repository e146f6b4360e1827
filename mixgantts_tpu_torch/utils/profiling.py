"""Throughput counters of the training loop (`mixgantts_tpu/utils/
profiling.py::ThroughputMeter`).  The device tracing of the JAX package's
module (`StepProfiler`, `start_server`) is not ported yet (ROADMAP item 8)."""

import time

import numpy as np


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
