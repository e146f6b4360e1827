"""Training-path anomaly guards (`mixgantts_tpu/train/guards.py`): a check
that every metric a step returned is finite, naming the step and the keys,
and `debug_nans`, autograd's anomaly mode, which names the backward
operation that produced the first NaN."""

import contextlib

import numpy as np
import torch


def check_finite_metrics(metrics, step):
    """Raise FloatingPointError if any metric is NaN or Inf.  `metrics` is
    the dict of scalars a train or eval step returned (tensors on any
    device, numpy or Python numbers)."""
    bad = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
            bad[k] = float(arr) if arr.ndim == 0 else arr
    if bad:
        raise FloatingPointError(
            f"non-finite training metrics at step {step}: "
            + ", ".join(f"{k}={v}" for k, v in sorted(bad.items()))
            + " — the run has diverged or hit a numerical bug; "
            "re-run under debug_nans() to locate the producing operation")


@contextlib.contextmanager
def debug_nans(enable=True):
    """Run the block under `torch.autograd.detect_anomaly`: a backward that
    produces NaN raises, naming the forward operation.  Slow, so opt-in."""
    if not enable:
        yield
        return
    with torch.autograd.detect_anomaly():
        yield
