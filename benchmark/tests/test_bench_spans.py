"""Device time by program span (`benchmark/spans.py`) on a stub of kineto's
event list, on the CPU: each device op goes to the spans open at its
launch (a launch from autograd's thread inside `train.backward` too),
`exclude` is honoured, launches and ops pair within the stretches between
host synchronisations, `Profile`'s own readings are what they were, and
the span readers read nothing from a profile without program spans."""

import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import core, run, spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SYNTH_READERS = ("encoder_ms.synth", "coarse_mel_ms.synth", "upsample_ms.synth",
                 "mrf_layout_ms.synth")
TRAIN_READERS = ("backward_ms.train", "losses_ms.train", "update_ms.train")


class Event:
    def __init__(self, name, start, end, kind, device=CPU, tid=1):
        self._name, self._start, self._end, self._kind = name, start, end, kind
        self._device, self.tid = device, tid

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._kind == "user_annotation"

    def activity_type(self):
        return self._kind


def span(name, start, end):
    return Event(name, start, end, "user_annotation")


def call(name, start, end=None, tid=1):
    return Event(name, start, start + 5 if end is None else end, "cuda_runtime", tid=tid)


def op(name, start, end, kind="kernel"):
    return Event(name, start, end, kind, device=CUDA)


def profile_of(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return trace.Profile(prof)


def stub_events(program_spans=True):
    """A stretch [0, 1000): a call's submit with the encoder and an MRF
    stage, a collect that synchronises, then a backward whose launch comes
    from a second thread, and a launch outside every span."""
    events = [span("profiled", 0, 1000), span("submit", 5, 405), span("collect", 408, 725),
              Event("aten::conv1d", 25, 60, "cpu_op")]
    if program_spans:
        events += [span("pipeline.submit", 10, 400), span("model.encoder", 20, 100),
                   span("vocoder.mrf", 150, 300), span("kernel.mrf_stack", 200, 280),
                   span("pipeline.collect", 410, 720), span("train.backward", 730, 900)]
    events += [call("cudaLaunchKernel", 30), call("cudaMalloc", 120),
               call("cudaLaunchKernelExC", 160), call("cuLaunchKernel", 210),
               call("cudaMemcpyAsync", 350), call("cudaStreamSynchronize", 420, 700),
               call("cudaLaunchKernel", 800, tid=2), call("cudaLaunchKernel", 950),
               op("gemm_encoder", 300, 350), op("layout_copy", 360, 420),
               op("mrf_pair_mma", 430, 600), op("Memcpy DtoH", 610, 650, "gpu_memcpy"),
               op("wgrad", 810, 860), op("elementwise", 960, 990),
               op("profiled", 0, 1000, "gpu_user_annotation")]
    return events


def test_each_op_goes_to_the_spans_open_at_its_launch():
    p = profile_of(stub_events())
    a = spans.Attribution(p)
    assert a.unpaired == 0 and len(a.pairs) == 6
    assert spans.span_device_s(p, ["model.encoder"]) == pytest.approx(50e-9)
    assert spans.span_device_s(p, ["vocoder.mrf"]) == pytest.approx(230e-9)
    assert spans.span_device_s(p, ["vocoder.mrf"], exclude=["kernel.mrf_stack"]) == \
        pytest.approx(60e-9)
    assert spans.span_device_s(p, ["pipeline.submit"]) == pytest.approx(320e-9)
    assert spans.span_device_s(p, ["model.encoder", "vocoder.mrf"]) == pytest.approx(280e-9)
    # the launch from the second thread, inside the main thread's backward
    assert spans.span_device_s(p, ["train.backward"]) == pytest.approx(50e-9)
    assert spans.span_device_s(p, ["pipeline.collect"]) == 0.0
    assert spans.span_device_s(p, ["no.such_span"]) is None


def test_a_missing_launch_stays_inside_its_stretch():
    events = [e for e in stub_events() if not (e.name() == "cudaLaunchKernelExC")]
    a = spans.Attribution(profile_of(events))
    # before the sync one kernel lost its launch: the later stretch pairs as before
    assert a.unpaired == 1
    p = profile_of(events)
    assert spans.span_device_s(p, ["train.backward"]) == pytest.approx(50e-9)


@pytest.mark.parametrize("lose_a_launch", [False, True])
def test_an_op_read_as_starting_before_the_sync_it_follows(lose_a_launch):
    """A cast launched inside `pipeline.collect` just after its sync, whose
    device start reads a little before the sync's end (the two clocks'
    skew), pairs with its launch: in order where the counts agree, by the
    op's midpoint where a lost launch makes them disagree."""
    events = stub_events() + [call("cudaLaunchKernel", 705), op("cast", 695, 725)]
    if lose_a_launch:
        events = [e for e in events if e.name() != "cudaLaunchKernelExC"]
    p = profile_of(events)
    assert spans.Attribution(p).unpaired == int(lose_a_launch)
    assert spans.span_device_s(p, ["pipeline.collect"]) == pytest.approx(30e-9)
    assert spans.span_device_s(p, ["train.backward"]) == pytest.approx(50e-9)


def test_profile_readings_are_unchanged():
    p = profile_of(stub_events())
    before = (p.window_s, p.busy_s, p.kernels(), p.kernel_s(("mrf_pair",)), p.gaps(),
              p.breakdown())
    assert p.window_s == pytest.approx(1e-6)
    assert p.busy_s == pytest.approx(400e-9)
    assert [k[2] for k in p.kernels()] == ["gemm_encoder", "layout_copy", "mrf_pair_mma",
                                           "wgrad", "elementwise"]
    assert p.kernel_s(("mrf_pair",)) == pytest.approx(170e-9)
    assert p.gaps() == [(0, 300), (350, 360), (420, 430), (600, 610), (650, 810),
                        (860, 960), (990, 1000)]
    gaps = p.breakdown()["idle_gaps"][:2]
    assert [g[0] for g in gaps] == ["submit/pipeline.submit/vocoder.mrf/no host operation",
                                    "train.backward/no host operation"]
    assert [g[1] for g in gaps] == pytest.approx([300e-9, 160e-9])
    for name in ("model.encoder", "vocoder.mrf", "train.backward"):
        spans.span_device_s(p, [name])
    assert (p.window_s, p.busy_s, p.kernels(), p.kernel_s(("mrf_pair",)), p.gaps(),
            p.breakdown()) == before


def readers(names):
    return {n: run.load_module(os.path.join(core.HERE, "metrics", n + ".py"),
                               "metric_" + n.replace(".", "_")) for n in names}


SYNTH = {"kind": "synth", "profiled": [7, 8]}
TRAIN = {"kind": "train", "steps_profiled": 2}


def test_readers_read_the_program_spans():
    p = profile_of(stub_events())
    got = {n: m.read(run.Readings(SYNTH, p)) for n, m in readers(SYNTH_READERS).items()}
    assert got["encoder_ms.synth"] == pytest.approx(1e3 * 50e-9 / 2)
    assert got["mrf_layout_ms.synth"] == pytest.approx(1e3 * 60e-9 / 2)
    assert got["coarse_mel_ms.synth"] is None and got["upsample_ms.synth"] is None
    got = {n: m.read(run.Readings(TRAIN, p)) for n, m in readers(TRAIN_READERS).items()}
    assert got["backward_ms.train"] == pytest.approx(1e3 * 50e-9 / 2)


@pytest.mark.parametrize("name", SYNTH_READERS + TRAIN_READERS)
def test_readers_read_nothing_without_program_spans(name):
    (reader,) = readers([name]).values()
    data = SYNTH if name.endswith(".synth") else TRAIN
    assert reader.read(run.Readings(data, profile_of(stub_events(program_spans=False)))) is None
    assert reader.read(run.Readings(data, None)) is None
    assert reader.read(run.Readings(None, None)) is None
