"""The one traffic generator: it reads a traffic file's parameters
(`traffic/<name>.json`) and makes the cell's inputs from the run's seed.

Every seed gets the same set of sizes, in another order: the sizes come
from the file's own `size_seed`, and the run's seed draws the order, the
phone ids and the values.  So two seeds give the device the same work.

- `synth`: batches of LJSpeech-like sentences for `TTSPipeline.submit`.
  `templates` batches of `batch` sentences, each of `words` words (uniform)
  of `phones_per_word` phones (uniform), are fixed by `size_seed`; each
  epoch the seed permutes the templates and the sentences inside each, and
  draws every phone id from the configuration's symbols.
- `train`: batches of `batch` synthetic utterances as the train CLI's
  dataset pads them (`AcousticDataset.reprocess`).  One multiset of
  `batch` utterance sizes is fixed by `size_seed` and every batch holds
  it, in an order the seed draws: L frames (uniform over `mel_frames`),
  about L / `frames_per_word` words of `phones_per_word` phones, and the
  L frames split over its phones.  Its mel, pitch and energy
  are drawn from the seed; its attention prior is a band along the
  diagonal, as the beta-binomial prior lies.

Speakers: a traffic file's `speaker` is one speaker id for every row, or
"uniform": each row's id drawn uniformly over the configuration's
`n_speakers` from a stream of its own (`rng(seed, "speakers")`), so that
the other draws stay what they are with a fixed speaker.
"""

import numpy as np

from .core import bucket, n_speakers, rng


def pad(rows, length, value=0):
    out = np.full((len(rows), length), value, dtype=np.asarray(rows[0]).dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


# --- synthesis ----------------------------------------------------------------------

def synth_templates(spec):
    """[template][sentence] -> phones per word (a list), fixed by size_seed."""
    r = np.random.default_rng(spec["size_seed"])
    lo, hi = spec["words"]
    plo, phi = spec["phones_per_word"]
    return [[list(r.integers(plo, phi + 1, size=r.integers(lo, hi + 1)))
             for _ in range(spec["batch"])] for _ in range(spec["templates"])]


def speaker_ids(spec, r, n, speakers):
    """[n] ids of `speakers` speakers as the traffic's `speaker` asks
    (module docstring), drawn from `r` where it says "uniform"."""
    if spec["speaker"] == "uniform":
        return r.integers(0, speakers, size=n)
    if not 0 <= int(spec["speaker"]) < speakers:
        raise ValueError(f"speaker {spec['speaker']} of a configuration of {speakers}")
    return np.full(n, int(spec["speaker"]))


def synth_batch(sentences, r, n_symbols, speaker):
    """A batch dict for `TTSPipeline.submit` from phones-per-word lists;
    `speaker` is one id or one a sentence."""
    texts = [r.integers(1, n_symbols + 1, size=int(sum(wb))) for wb in sentences]
    return {"texts": pad(texts, max(len(t) for t in texts)).astype(np.int64),
            "src_lens": np.array([len(t) for t in texts], dtype=np.int64),
            "word_boundaries": pad([np.array(wb) for wb in sentences],
                                   max(len(wb) for wb in sentences)).astype(np.int64),
            "src_w_lens": np.array([len(wb) for wb in sentences], dtype=np.int64),
            "speakers": np.broadcast_to(np.asarray(speaker, dtype=np.int64),
                                        (len(sentences),)).copy()}


def synth_stream(spec, seed, n_symbols, n_speakers=1):
    """Batches without end: each epoch every template once, in an order
    the seed draws, its sentences shuffled."""
    templates = synth_templates(spec)
    r, spk = rng(seed, "synth"), rng(seed, "speakers")
    while True:
        for t in r.permutation(len(templates)):
            rows = r.permutation(len(templates[t]))
            speakers = speaker_ids(spec, spk, len(rows), n_speakers)
            yield synth_batch([templates[t][i] for i in rows], r, n_symbols, speakers)


def synth_shapes(spec, config):
    """The distinct (phone slots, word slots) the pipeline pads the
    templates to: the shapes the cell warms up."""
    buckets = config["model"]["tpu"]["phone_buckets"]
    return sorted({(bucket(max(sum(s) for s in t), buckets),
                    bucket(max(len(s) for s in t), buckets)) for t in synth_templates(spec)})


# --- training ------------------------------------------------------------------------

def train_sizes(spec):
    """The utterances every batch holds, fixed by size_seed: (mel frames,
    phones per word, frames per phone), the longest at the top of
    `mel_frames` so that it sets the frame bucket."""
    r = np.random.default_rng(spec["size_seed"])
    lo, hi = spec["mel_frames"]
    plo, phi = spec["phones_per_word"]
    sizes = []
    for i in range(spec["batch"]):
        L = hi if i == 0 else int(r.integers(lo, hi + 1))
        wb = r.integers(plo, phi + 1, size=max(1, int(round(L / spec["frames_per_word"]))))
        P = int(wb.sum())
        cuts = np.sort(r.choice(np.arange(1, L), size=P - 1, replace=False))
        sizes.append((L, wb, np.diff(np.concatenate([[0], cuts, [L]])).astype(np.int64)))
    return sizes


def _utterance(size, r, n_symbols, stats):
    L, wb, dur = size
    P = len(dur)
    mel = np.clip(r.normal(-5.0, 2.0, size=(L, 80)), stats["spec_min"][0],
                  stats["spec_max"][0]).astype(np.float32)
    f = (np.arange(L) + 0.5) / L
    p = (np.arange(P) + 0.5) / P
    prior = np.exp(-np.square(p[:, None] - f[None, :]) / (2 * 0.05 ** 2)) + 1e-4
    prior = (prior / prior.sum(axis=0, keepdims=True)).astype(np.float32)
    return {"text": r.integers(1, n_symbols + 1, size=P), "wb": wb, "dur": dur, "mel": mel,
            "pitch": r.normal(0.0, 1.0, size=P).astype(np.float32),
            "energy": r.normal(0.0, 1.0, size=P).astype(np.float32), "prior": prior}


def train_batch(spec, r, n_symbols, stats, config, spk=None):
    """One padded batch dict, as `AcousticDataset.reprocess` gives it;
    speaker ids drawn from `spk` where the traffic asks (`speaker_ids`)."""
    tpu = config["model"]["tpu"]
    sizes = train_sizes(spec)
    items = [_utterance(sizes[i], r, n_symbols, stats) for i in r.permutation(len(sizes))]
    P = bucket(max(len(d["text"]) for d in items), tpu["phone_buckets"])
    W = bucket(max(len(d["wb"]) for d in items), tpu["phone_buckets"])
    T = bucket(max(len(d["mel"]) for d in items), tpu["length_buckets"])
    mels = np.zeros((len(items), T, 80), dtype=np.float32)
    priors = np.zeros((len(items), P, T), dtype=np.float32)
    for i, d in enumerate(items):
        mels[i, :len(d["mel"])] = d["mel"]
        priors[i, :d["prior"].shape[0], :d["prior"].shape[1]] = d["prior"]
    return {"speakers": speaker_ids(spec, spk, len(items), n_speakers(config)).astype(np.int64),
            "texts": pad([d["text"] for d in items], P).astype(np.int64),
            "src_lens": np.array([len(d["text"]) for d in items], dtype=np.int64),
            "word_boundaries": pad([d["wb"] for d in items], W).astype(np.int64),
            "src_w_lens": np.array([len(d["wb"]) for d in items], dtype=np.int64),
            "mels": mels,
            "mel_lens": np.array([len(d["mel"]) for d in items], dtype=np.int64),
            "p_targets": pad([d["pitch"] for d in items], P).astype(np.float32),
            "e_targets": pad([d["energy"] for d in items], P).astype(np.float32),
            "d_targets": pad([d["dur"] for d in items], P).astype(np.int64),
            "attn_priors": priors}


def train_pool(spec, seed, config):
    """The `pool` batches a run trains on, in turn."""
    r, spk = rng(seed, "train"), rng(seed, "speakers")
    return [train_batch(spec, r, config["n_symbols"], config["stats"], config, spk)
            for _ in range(spec["pool"])]
