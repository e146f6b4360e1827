"""The reference against the program at tiny width on the CPU, and what
the benchmark imports (CPU).

The drivers' self-test runs the program's CPU path (the kernels' plain
versions in their bf16 operand type) and judges it with the reference:
synthesis and the first three training steps agree to float32 rounding,
the MRF's plain version excepted (it sums in float64, the reference in
float32, so bf16 rounding flips can differ)."""

import argparse
import ast
import os

import pytest

from benchmark import run
from benchmark.core import FORBIDDEN, HERE, find_cell

BENCH_DIR = HERE
REF_DIR = os.path.join(HERE, "reference")


def self_test(name):
    cell, config, traffic, _ = find_cell(name)
    args = argparse.Namespace(workload=name, seed=2 ** 31 + 77, seconds=1, trace=0)
    out, _ = run.self_test(args, cell, config, traffic)
    return out


def test_synthesis_matches_the_program():
    checks = self_test("lj_v1.synth_b32")["checks"]
    assert checks["decision_gap"] == 0.0
    for name in ("features_err", "coarse_mel_err", "mel_err"):
        assert checks[name] < 1e-6, (name, checks[name])
    assert checks["wave_err"] < 2e-3


def test_training_steps_match_the_program():
    checks = self_test("lj_v1.train_b64")["checks"]
    for name, value in checks.items():
        assert value < 1e-6, (name, value)


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def python_files(root):
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(python_files(REF_DIR)))
def test_reference_imports_nothing_of_either_package(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "mixgantts_tpu", "mixgantts_tpu_torch"}, tops


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in python_files(BENCH_DIR):
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops)


def test_the_comparison_takes_whole_top_level_names():
    assert "mixgantts_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "mixgantts_tpu.models".split(".")[0] in FORBIDDEN
