"""The encoder's graph share (`metrics/encoder_graph_pct.synth.py`) on a
stub of kineto's event list, on the CPU: the share of `model.encoder`
spans that hold an `encoder.replay` span; 0 for a program that never
replays (the eager encoder), None without the program's spans or outside
a traced synthesis run."""

import pytest

from benchmark import run
from benchmark.tests.test_bench_spans import SYNTH, TRAIN, profile_of, readers, span, stub_events

NAME = "encoder_graph_pct.synth"


def read(events, data=SYNTH):
    (reader,) = readers([NAME]).values()
    return reader.read(run.Readings(data, None if events is None else profile_of(events)))


def calls(replayed):
    """Three more calls' encoder spans after the stub's, each holding a
    replay where `replayed` says so, and a replay outside every encoder."""
    events = [span("encoder.replay", 995, 998)]
    for i, r in enumerate(replayed):
        start = 920 + 20 * i
        events.append(span("model.encoder", start, start + 10))
        if r:
            events.append(span("encoder.replay", start + 2, start + 8))
    return events


@pytest.mark.parametrize("replayed, want", [((True, True, True), 75.0),
                                            ((True, False, True), 50.0),
                                            ((False, False, False), 0.0)])
def test_share_of_encoder_calls_that_replayed(replayed, want):
    # the stub's own `model.encoder` span (20-100) holds no replay
    assert read(stub_events() + calls(replayed)) == pytest.approx(want)


def test_an_eager_program_reads_zero():
    assert read(stub_events()) == 0.0


def test_nothing_to_read():
    assert read(stub_events(program_spans=False)) is None
    assert read(None) is None
    assert read(stub_events(), data=TRAIN) is None
    assert read(stub_events(), data=None) is None
