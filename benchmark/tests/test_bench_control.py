"""The control comes out as not correct, on the card at the cell's own
size: the reference in the next precision below the configuration's
(TF32 for its float32, fp8 for the kernels' bf16 operands), put in the
program's place, on three seeds, each run of the cell's driver with a
window of two seconds.  Run on the chip:

    python3 -m pytest benchmark/tests/test_bench_control.py -m gpu
"""

import argparse

import pytest
import torch

from benchmark import calibrate, run
from benchmark.checks import verdict
from benchmark.core import find_cell
from benchmark.reference.arith import CONTROL

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["lj_v1.synth_b32", "lj_v2.synth_b32", "lj_v1.train_b64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card (no CUDA device here)")
    name = cell
    cell, config, traffic, _ = find_cell(name)
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    args = argparse.Namespace(workload=name, seed=seed, seconds=2, trace=0)
    ctx = run.make_context(args, cell, config, traffic, device)
    if traffic["driver"] == "train":
        ctx.stand_in = calibrate.control_train
    else:
        ctx.arith = CONTROL
    out = run.driver_of(traffic).run(ctx)
    correct, rows = verdict(out["checks"], ctx.limits)
    assert not correct, rows
