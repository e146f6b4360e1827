"""Datasets over the preprocessed corpus (`mixgantts_tpu/data/dataset.py`).

Metadata lines "basename|speaker|{phones}|raw_text" in `train.txt`,
`val.txt` or a batch-synthesis source file; per utterance the `.npy`
artifacts under `preprocessed_path/{kind}/{speaker}-{kind}-{basename}.npy`
(mel, pitch, energy, duration, phones_per_word, attn_prior), the speaker
ids in `speakers.json`, and for a multi-speaker model with an external
speaker embedder each speaker's `spker_embed/{speaker}-spker_embed.npy`
(batched as `spker_embeds` [B, D]).

- `AcousticDataset`: training and validation batches, the reference's
  grouped sorted batching (batch_size * group_size utterances drawn, sorted
  by text length, split into batches), shuffled by
  `np.random.RandomState(seed)` so that a seed gives the JAX package's
  batches in its order, and `None` at each epoch's end.
- `TextOnlyDataset`: text and word boundaries only, for batch synthesis.

Batches are numpy dicts padded to the bucketed lengths of model.yaml's
`tpu.length_buckets` (frames) and `tpu.phone_buckets` (phones, and words
to their own phone bucket), as in the JAX package.
"""

import json
import os

import numpy as np

from ..text import text_to_sequence
from ..utils.tools import bucket_length, pad_1d, pad_2d, pad_3d


class AcousticDataset:
    """Training and validation dataset (the reference's `Dataset`)."""

    def __init__(self, filename, mode, preprocess_config, model_config,
                 train_config, sort=False, drop_last=False):
        pp = preprocess_config["preprocessing"]
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.cleaners = pp["text"]["text_cleaners"]
        self.batch_size = train_config["optimizer"][
            "batch_size" if mode != "shallow" else "batch_size_shallow"]
        self.load_spker_embed = (model_config["multi_speaker"]
                                 and pp.get("speaker_embedder", "none") != "none")
        tpu_cfg = model_config.get("tpu", {})
        self.length_buckets = tuple(tpu_cfg.get("length_buckets", ()))
        self.phone_buckets = tuple(tpu_cfg.get("phone_buckets", ()))
        self.sort = sort
        self.drop_last = drop_last
        self.basename, self.speaker, self.text, self.raw_text = _read_meta(
            os.path.join(self.preprocessed_path, filename))
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.text)

    @staticmethod
    def _load(path):
        return np.load(path)

    @staticmethod
    def _header(path):
        """Zeros of the shape and type of the `.npy` array at `path`, read
        from the file's header alone (a read-only broadcast view)."""
        array = np.load(path, mmap_mode="r")
        return np.broadcast_to(np.zeros((), array.dtype), array.shape)

    def __getitem__(self, idx):
        return self.item(idx, self._load)

    def item(self, idx, read):
        """Utterance `idx` with its `.npy` artifacts through `read(path)`:
        `_load` for the arrays, `_header` for their shapes alone."""
        basename = self.basename[idx]
        speaker = self.speaker[idx]

        def artifact(kind):
            return read(os.path.join(self.preprocessed_path, kind,
                                     f"{speaker}-{kind}-{basename}.npy"))

        sample = {
            "id": basename,
            "speaker": self.speaker_map[speaker],
            "raw_text": self.raw_text[idx],
            "text": self.sequence(idx),
            "mel": artifact("mel"),
            "pitch": artifact("pitch"),
            "energy": artifact("energy"),
            "duration": artifact("duration"),
            "word_boundary": artifact("phones_per_word"),
            "attn_prior": artifact("attn_prior"),
        }
        if self.load_spker_embed:
            sample["spker_embed"] = read(os.path.join(
                self.preprocessed_path, "spker_embed", f"{speaker}-spker_embed.npy"))
        return sample

    def sequence(self, idx):
        """Utterance `idx`'s phone ids."""
        return np.array(text_to_sequence(self.text[idx], self.cleaners))

    def reprocess(self, data, idxs):
        """idxs -> one padded batch dict (the reference's 17-field batch)."""
        items = [data[i] for i in idxs]
        text_lens = np.array([len(d["text"]) for d in items])
        word_lens = np.array([len(d["word_boundary"]) for d in items])
        mel_lens = np.array([d["mel"].shape[0] for d in items])
        P = bucket_length(int(text_lens.max()), self.phone_buckets)
        W = bucket_length(int(word_lens.max()), self.phone_buckets)
        T = bucket_length(int(mel_lens.max()), self.length_buckets)
        batch = {
            "ids": [d["id"] for d in items],
            "raw_texts": [d["raw_text"] for d in items],
            "speakers": np.array([d["speaker"] for d in items]),
            "texts": pad_1d([d["text"] for d in items], P),
            "src_lens": text_lens,
            "word_boundaries": pad_1d([d["word_boundary"] for d in items], W),
            "src_w_lens": word_lens,
            "mels": pad_2d([d["mel"] for d in items], T).astype(np.float32),
            "mel_lens": mel_lens,
            "p_targets": pad_1d([d["pitch"] for d in items], P).astype(np.float32),
            "e_targets": pad_1d([d["energy"] for d in items], P).astype(np.float32),
            "d_targets": pad_1d([d["duration"] for d in items], P),
            "attn_priors": pad_3d([d["attn_prior"] for d in items], len(items), P, T),
        }
        if self.load_spker_embed:
            batch["spker_embeds"] = np.stack(
                [np.asarray(d["spker_embed"]).reshape(-1) for d in items]).astype(np.float32)
        return batch

    def groups(self, text_lens):
        """Grouped sorted batching: positions in a draw sorted by text
        length, longest first, and cut into batches of batch_size (the rest
        is one more batch unless drop_last)."""
        if self.sort:
            idx_arr = np.argsort(-np.array(text_lens))
        else:
            idx_arr = np.arange(len(text_lens))
        n_full = len(idx_arr) - len(idx_arr) % self.batch_size
        groups = idx_arr[:n_full].reshape(-1, self.batch_size).tolist()
        if not self.drop_last and n_full < len(idx_arr):
            groups.append(idx_arr[n_full:].tolist())
        return groups

    def batches(self, group_size=4, shuffle=True, seed=0, epochs=None, replayed=()):
        """Padded batch dicts without end (or for `epochs`), each epoch
        followed by None.  Each draw of batch_size * group_size utterances
        yields group_size batches; a corpus smaller than one draw shrinks
        the draw so that an epoch still yields a batch.

        The batches at the stream positions in `replayed` (counting batches
        from 0, not the None markers) are built from the `.npy` headers
        alone: their shapes and types, zeros for values, and no array read.
        A resumed training run replays the batches it has trained on so
        (`cli/train.py`); the draws are the same either way."""
        rng = np.random.RandomState(seed)
        epoch = position = 0
        chunk = self.batch_size * group_size
        if len(self) < chunk:
            chunk = max((len(self) // self.batch_size) * self.batch_size,
                        min(len(self), self.batch_size))
        while epochs is None or epoch < epochs:
            order = np.arange(len(self))
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order) - chunk + 1, chunk):
                draw = order[i:i + chunk]
                for group in self.groups([len(self.sequence(j)) for j in draw]):
                    read = self._header if position in replayed else self._load
                    items = [self.item(draw[n], read) for n in group]
                    yield self.reprocess(items, range(len(items)))
                    position += 1
            epoch += 1
            yield None


def _read_meta(path):
    """(basenames, speakers, phone strings, raw texts) of a metadata file."""
    name, speaker, text, raw_text = [], [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            n, s, t, r = line.strip("\n").split("|")
            name.append(n)
            speaker.append(s)
            text.append(t)
            raw_text.append(r)
    return name, speaker, text, raw_text


class TextOnlyDataset:
    """Text and word boundaries only (the reference's `TextDataset`)."""

    def __init__(self, filepath, preprocess_config, model_config):
        pp = preprocess_config["preprocessing"]
        self.cleaners = pp["text"]["text_cleaners"]
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.load_spker_embed = (model_config["multi_speaker"]
                                 and pp.get("speaker_embedder", "none") != "none")
        self.phone_buckets = tuple(model_config.get("tpu", {}).get("phone_buckets", ()))

        self.basename, self.speaker, self.text, self.raw_text = _read_meta(filepath)
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.text)

    def __getitem__(self, idx):
        speaker = self.speaker[idx]
        item = {
            "id": self.basename[idx],
            "speaker": self.speaker_map[speaker],
            "raw_text": self.raw_text[idx],
            "text": np.array(text_to_sequence(self.text[idx], self.cleaners)),
            "word_boundary": np.load(os.path.join(
                self.preprocessed_path, "phones_per_word",
                f"{speaker}-phones_per_word-{self.basename[idx]}.npy")),
        }
        if self.load_spker_embed:
            item["spker_embed"] = np.load(os.path.join(
                self.preprocessed_path, "spker_embed", f"{speaker}-spker_embed.npy"))
        return item

    def collate(self, items):
        text_lens = np.array([len(d["text"]) for d in items])
        word_lens = np.array([len(d["word_boundary"]) for d in items])
        P = bucket_length(int(text_lens.max()), self.phone_buckets)
        W = bucket_length(int(word_lens.max()), self.phone_buckets)
        batch = {
            "ids": [d["id"] for d in items],
            "raw_texts": [d["raw_text"] for d in items],
            "speakers": np.array([d["speaker"] for d in items]),
            "texts": pad_1d([d["text"] for d in items], P),
            "src_lens": text_lens,
            "word_boundaries": pad_1d([d["word_boundary"] for d in items], W),
            "src_w_lens": word_lens,
        }
        if self.load_spker_embed:
            batch["spker_embeds"] = np.stack(
                [np.asarray(d["spker_embed"]).reshape(-1) for d in items]).astype(np.float32)
        return batch

    def batches(self, batch_size=8):
        for i in range(0, len(self), batch_size):
            yield self.collate([self[j] for j in range(i, min(i + batch_size, len(self)))])
