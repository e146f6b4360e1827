"""Opt-in GPU performance floor, the counterpart of tests/test_tpu_perf.py.

Runs the port's benchmark (`python -m mixgantts_tpu_torch.bench`) in a
subprocess and asserts that the shallow LJSpeech synthesis RTF under its
definition (the 864-frame request, 32 back to back, best of 5 rounds)
stays under RTF_FLOOR, about 3x the measured value, the margin
test_tpu_perf.py keeps: well clear of the run-to-run spread of a request
that the host's launches bound.

Opt-in: MIXGANTTS_GPU_PERF=1 (the default suite runs on the CPU).  Once
opted in, a machine without a CUDA device fails the test: the bench prints
a null value there.  This file imports no JAX, so on the card:

    MIXGANTTS_GPU_PERF=1 python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_gpu_perf.py
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ~3x the measured RTF: 0.0017013 alone and 0.0022019 in chip_smoke.py's
# phase 17 (NVIDIA H100 80GB HBM3, 700.00 W power limit, one chip run)
RTF_FLOOR = 0.006


@pytest.mark.gpu
def test_shallow_synthesis_rtf_floor():
    if not os.environ.get("MIXGANTTS_GPU_PERF"):
        pytest.skip("opt-in GPU perf test (set MIXGANTTS_GPU_PERF=1; needs a CUDA device)")
    out = subprocess.run([sys.executable, "-m", "mixgantts_tpu_torch.bench"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert lines, (out.stdout, out.stderr[-2000:])
    result = json.loads(lines[-1])
    assert out.returncode == 0 and result["value"] is not None, (result, out.stderr[-2000:])
    assert result["value"] < RTF_FLOOR, (
        f"shallow synthesis RTF regressed: {result['value']} >= {RTF_FLOOR}", result)
