"""The command's plumbing on the CPU: each cell's self-test runs its
driver at tiny widths and prints no result; the real command without a
card exits non-zero and prints no result."""

import pytest
import torch

from benchmark import run

CELLS = ("lj_v1.synth_b32", "lj_v2.synth_b32", "lj_v1.train_b64")


@pytest.mark.parametrize("cell", CELLS)
def test_self_test_prints_no_result(cell, capsys):
    assert run.main(["--workload", cell, "--self-test", "--seed", "5"]) == 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
def test_without_a_card_it_fails_and_prints_nothing(cell, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.main(["--workload", "no_such_cell", "--self-test"])
