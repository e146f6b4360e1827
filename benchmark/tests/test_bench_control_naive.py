"""The control comes out as not correct in `lj_naive_v2.synth_b32`, on the
card at the cell's own size: the reference in the next precision below the
configuration's (TF32 for its float32, fp8 for the kernels' bf16
operands), put in the program's place, on three seeds, each a run of the
cell with a window of two seconds.  Run on the chip:

    python3 -m pytest benchmark/tests/test_bench_control_naive.py -m gpu
"""

import pytest

from benchmark.tests import test_bench_control as control


@pytest.mark.gpu
@pytest.mark.parametrize("seed", control.SEEDS)
def test_naive_control_is_not_correct(seed):
    control.test_control_is_not_correct("lj_naive_v2.synth_b32", seed)
