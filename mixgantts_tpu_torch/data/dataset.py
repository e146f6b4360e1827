"""Batch synthesis input (`mixgantts_tpu/data/dataset.py`, `TextOnlyDataset`
only): a source file of metadata lines "basename|speaker|{phones}|raw_text",
with each utterance's phones per word in
`preprocessed_path/phones_per_word/{speaker}-phones_per_word-{basename}.npy`
and the speaker ids in `preprocessed_path/speakers.json`.  A multi-speaker
model with an external speaker embedder also reads each speaker's embedding,
`preprocessed_path/spker_embed/{speaker}-spker_embed.npy`, into the batch's
`spker_embeds` [B, D].  Batches are padded to the bucketed lengths of
model.yaml's `tpu.phone_buckets`, as in the JAX package.
"""

import json
import os

import numpy as np

from ..text import text_to_sequence
from ..utils.tools import bucket_length, pad_1d


class TextOnlyDataset:
    """Text and word boundaries only (the reference's `TextDataset`)."""

    def __init__(self, filepath, preprocess_config, model_config):
        pp = preprocess_config["preprocessing"]
        self.cleaners = pp["text"]["text_cleaners"]
        self.preprocessed_path = preprocess_config["path"]["preprocessed_path"]
        self.load_spker_embed = (model_config["multi_speaker"]
                                 and pp.get("speaker_embedder", "none") != "none")
        self.phone_buckets = tuple(model_config.get("tpu", {}).get("phone_buckets", ()))

        self.basename, self.speaker, self.text, self.raw_text = [], [], [], []
        with open(filepath, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                n, s, t, r = line.strip("\n").split("|")
                self.basename.append(n)
                self.speaker.append(s)
                self.text.append(t)
                self.raw_text.append(r)
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
