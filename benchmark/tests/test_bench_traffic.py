"""The traffic generator: a seed gives the same stream, every seed the
same sizes, and the batches land at the expected buckets (CPU)."""

import itertools

import numpy as np
import pytest

from benchmark import traffic as T
from benchmark.core import HERE, frame_bucket, load_json, sub_seed

V1 = load_json(HERE, "configs", "ljspeech_shallow_v1.json")
SYNTH = load_json(HERE, "traffic", "synth_b32.json")
TRAIN = dict(load_json(HERE, "traffic", "train_b64.json"), pool=3)
BIG = 2 ** 31 + 12345


def take(stream, n):
    return list(itertools.islice(stream, n))


def same(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_synth_stream_repeats_for_a_seed(seed):
    a, b = take(T.synth_stream(SYNTH, seed, 360), 10), take(T.synth_stream(SYNTH, seed, 360), 10)
    assert all(same(x, y) for x, y in zip(a, b))


def test_synth_seeds_differ_in_order_and_ids_not_in_sizes():
    a, b = take(T.synth_stream(SYNTH, 1, 360), 8), take(T.synth_stream(SYNTH, 2, 360), 8)
    assert not all(same(x, y) for x, y in zip(a, b))
    sizes = [sorted(tuple(sorted(x["src_lens"])) for x in s) for s in (a, b)]
    assert sizes[0] == sizes[1]      # one epoch: every template once


def test_synth_buckets():
    assert T.synth_shapes(SYNTH, V1) == [(128, 32), (128, 64), (192, 64)]
    for batch in take(T.synth_stream(SYNTH, BIG, 360), 16):
        assert batch["texts"].shape[0] == 32
        assert 8 <= batch["src_lens"].min() and batch["src_lens"].max() <= 180
        assert frame_bucket(V1, batch["texts"].shape[1]) == 1000
        assert batch["texts"].min() >= 0 and batch["texts"].max() <= 360
        for row, n in zip(batch["texts"], batch["src_lens"]):
            assert (row[:n] > 0).all() and (row[n:] == 0).all()


@pytest.mark.parametrize("seed", [3, BIG])
def test_train_pool_repeats_for_a_seed_and_lands_at_bucket_1000(seed):
    a, b = T.train_pool(TRAIN, seed, V1), T.train_pool(TRAIN, seed, V1)
    assert all(same(x, y) for x, y in zip(a, b))
    for batch in a:
        assert batch["mels"].shape == (64, 1000, 80)
        assert batch["texts"].shape == (64, 128) and batch["word_boundaries"].shape == (64, 64)
        assert batch["attn_priors"].shape == (64, 128, 1000)
        assert (batch["d_targets"].sum(axis=1) == batch["mel_lens"]).all()
        assert (batch["word_boundaries"].sum(axis=1) == batch["src_lens"]).all()
        assert int(batch["mel_lens"].sum()) == 35908


def test_train_rows_all_differ_and_seeds_share_sizes():
    a, b = T.train_pool(TRAIN, 1, V1), T.train_pool(TRAIN, 2, V1)
    assert sorted(a[0]["mel_lens"]) == sorted(b[0]["mel_lens"])
    rows = [m[:n].tobytes() for batch in a for m, n in zip(batch["mels"], batch["mel_lens"])]
    assert len(set(rows)) == len(rows)


def test_sub_seeds_take_any_whole_number():
    assert sub_seed(BIG, "x") != sub_seed(BIG + 1, "x")
    assert 0 <= sub_seed(2 ** 70, "w") < 2 ** 63
