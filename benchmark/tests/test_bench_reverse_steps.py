"""The reverse loop's readers (`metrics/reverse_step_ms.synth.py`,
`metrics/reverse_enqueue_ms.synth.py`) on a stub of kineto's event list,
on the CPU, and the cell that reports them, `lj_naive_v2.synth_b32`.

The stub is a stretch of 3 naive calls of 4 reverse steps each: every
call's encoder replays a CUDA graph of 678 kernels that no launch of the
stub pairs with, and its steps launch sets that run no device op, so a
pairing of ops with launches (`benchmark/spans.py`) would misread it.  The
step reader splits the denoiser kernels into one group a step and gives the
mean interval between the ends of consecutive steps' last kernels within a
call; it reads nothing at one step a call or where the kernels do not
split evenly.  The enqueue reader gives the mean host time of the
`diffusion.step` spans.
"""

import pytest
import torch

from benchmark import core, run
from benchmark.tests.test_bench_spans import SYNTH, TRAIN, call, op, profile_of, readers, span

CELL = "lj_naive_v2.synth_b32"
STEP, ENQUEUE = "reverse_step_ms.synth", "reverse_enqueue_ms.synth"
PERIODS = (400, 500, 600)   # device ns a step, by call
GRAPH_KERNELS = 678
DENOISER = "void (anonymous namespace)::residual_stack_mma<256>(float const*)"


def stretch(steps=4, periods=PERIODS, denoiser_launches=2, drop=None):
    """Events of a profiled stretch of len(periods) calls of `steps` reverse
    steps; call c's steps run on the device every periods[c] ns, and its
    k-th step span lasts 40 + 10 k ns on the host.  `drop` (call, step)
    leaves out that step's last denoiser kernel."""
    events = [span("profiled", 0, 100_000)]
    for c, period in enumerate(periods):
        base = 1_000 + 30_000 * c
        events += [span("submit", base, base + 9_000), span("pipeline.submit", base + 10, base + 8_990),
                   span("model.encoder", base + 100, base + 600),
                   span("encoder.replay", base + 200, base + 500),
                   call("cudaGraphLaunch", base + 300)]
        events += [op(f"graph_kernel_{i}", base + 1_000 + 5 * i, base + 1_004 + 5 * i)
                   for i in range(GRAPH_KERNELS)]
        diffusion = base + 1_000
        events.append(span("model.diffusion", diffusion, diffusion + 100 * steps))
        for k in range(steps):
            host = diffusion + 100 * k
            events += [span("diffusion.step", host, host + 40 + 10 * k),
                       call("cudaMemsetAsync", host + 1), call("cudaLaunchKernel", host + 2)]
            dev = base + 5_000 + period * k
            events.append(op("gemm_condp", dev, dev + 50))
            for j in range(denoiser_launches):
                if drop == (c, k) and j == denoiser_launches - 1:
                    continue
                events.append(op(DENOISER, dev + 60 + 100 * j, dev + 150 + 100 * j))
            events.append(op("elementwise_posterior", dev + 300, dev + 320))
        events += [span("vocoder.mrf", base + 2_000, base + 3_000),
                   op("mrf_stage_narrow", base + 9_000, base + 9_500)]
    return events


def read(name, events, data=SYNTH):
    (reader,) = readers([name]).values()
    return reader.read(run.Readings(data, None if events is None else profile_of(events)))


@pytest.mark.parametrize("denoiser_launches", [1, 2])
def test_a_step_is_the_interval_between_the_ends_of_consecutive_steps(denoiser_launches):
    events = stretch(denoiser_launches=denoiser_launches)
    # 3 calls x 3 intervals of 400, 500 and 600 ns
    assert read(STEP, events) == pytest.approx(1e-6 * sum(PERIODS) / len(PERIODS))


def test_the_mean_is_over_the_intervals_inside_each_call():
    # the gaps between calls (~30 us) never count
    assert read(STEP, stretch(steps=2, periods=(400, 900))) == pytest.approx(1e-6 * 650)


def test_no_step_reading_at_one_step_a_call_or_on_an_uneven_count():
    assert read(STEP, stretch(steps=1)) is None
    assert read(STEP, stretch(drop=(1, 2))) is None


def test_enqueue_is_the_mean_host_time_of_the_step_spans():
    # each call's steps last 40, 50, 60 and 70 ns
    assert read(ENQUEUE, stretch()) == pytest.approx(1e-6 * 55)
    assert read(ENQUEUE, stretch(steps=1)) == pytest.approx(1e-6 * 40)


@pytest.mark.parametrize("name", [STEP, ENQUEUE])
def test_nothing_to_read(name):
    # a program without the spans (the reverse loop before it had them)
    bare = [e for e in stretch() if e.name() != "diffusion.step"]
    assert read(name, bare) is None
    assert read(name, None) is None
    assert read(name, stretch(), data=TRAIN) is None
    assert read(name, stretch(), data=None) is None


def test_the_cell_reports_the_naive_metrics_and_not_the_misread_ones():
    cell, config, traffic, bench = core.find_cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("ljspeech_naive_v2", "synth_b32", 1)
    assert config["mode"] == "naive" and core.reference_of(config).mode == "naive"
    names = {m["name"] for m in run.cell_metrics(bench, CELL, "per_layer")}
    assert {STEP, ENQUEUE, "denoiser_roofline", "encoder_graph_pct.synth"} <= names
    assert not names & {"coarse_mel_ms.synth", "encoder_ms.synth", "upsample_ms.synth",
                        "mrf_layout_ms.synth"}
    for other in ("lj_v1.synth_b32", "lj_v2.synth_b32"):
        assert not {STEP, ENQUEUE} & {m["name"] for m in run.cell_metrics(bench, other, "per_layer")}
    assert {m["name"] for m in run.cell_metrics(bench, CELL, "end_to_end")} == \
        {"utt_per_s", "synth_p95_ms", "setup_s"}
    assert set(core.limits_of(CELL)) == {"decision_gap", "features_err", "mel_err", "wave_err"}


def test_the_cell_self_test_prints_no_result(capsys, monkeypatch):
    assert run.main(["--workload", CELL, "--self-test", "--seed", str(2 ** 33 + 24)]) == 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
