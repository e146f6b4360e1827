"""Offline feature-extraction pipeline (`mixgantts_tpu/data/preprocessor.py`).

Behavior parity with `preprocessor/preprocessor.py` in the reference:
MFA TextGrid alignment -> phone/word durations with silence trimming
(:395-452), F0 (:294-300, here the in-repo NCCF tracker instead of pyworld),
mel+energy (:306-309; the host `get_mel_from_wav`, as the JAX package
computes them, so the artifacts equal its own), phoneme-level averaging with unvoiced
interpolation (:311-341), beta-binomial attention prior (:343-348, 384-393),
six .npy artifact families + spker_embed, corpus-level StandardScaler
normalization with IQR outlier removal (:458-479), stats.json /
speakers.json / sorted train-val split (:167-259).  Artifact names and the
metadata format ("basename|speaker|{phones}|raw_text") match the reference
so preprocessed datasets are drop-in interchangeable.

Everything but the DeepSpeaker speaker embedding is host numpy, as in the
JAX package; the embedding's network runs on `device` (cuda unless the
caller names another).  `Preprocessor.seconds` adds up the host time of
each part of `build_from_path` (alignment and priors, F0, mel and energy,
the speaker embedding, the writes).
"""

import collections
import contextlib
import json
import os
import random
import time

import numpy as np
from scipy.stats import betabinom

from ..audio.f0 import extract_f0, extract_f0_dio, interpolate_unvoiced
from ..audio.stft import TacotronSTFT
from ..audio.wav import load_wav
from ..utils.tools import word_level_subdivision
from .textgrid import read_textgrid

SIL_PHONES = ["sil", "sp", "spn"]


class RunningScaler:
    """Streaming mean/std (sklearn StandardScaler.partial_fit equivalent)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def partial_fit(self, values):
        for v in np.asarray(values, dtype=np.float64).ravel():
            self.n += 1
            delta = v - self.mean
            self.mean += delta / self.n
            self.m2 += delta * (v - self.mean)

    @property
    def scale(self):
        if self.n < 2:
            return 1.0
        return float(np.sqrt(self.m2 / self.n))


def beta_binomial_prior(n_mel_frames, n_phones, scaling_factor=1.0):
    """[n_phones, n_mel_frames] alignment prior
    (`preprocessor/preprocessor.py:384-393`; note the reference's argument
    names are swapped — rows are phones, columns are mel frames)."""
    x = np.arange(n_mel_frames)
    rows = []
    for i in range(1, n_phones + 1):
        a, b = scaling_factor * i, scaling_factor * (n_phones + 1 - i)
        rows.append(betabinom(n_mel_frames, a, b).pmf(x))
    return np.array(rows)


def get_alignment(tier_phones, tier_words, sampling_rate, hop_length):
    """TextGrid tiers -> (phones, frame durations, start, end,
    phones_per_word), trimming leading/trailing silences
    (`preprocessor/preprocessor.py:395-452`)."""
    phones, durations, phones_per_word = [], [], []
    word_idx = 0
    phone_count = 0
    start_time = end_time = 0.0
    end_idx = 0
    words = tier_words.intervals
    for (s, e, p) in tier_phones.intervals:
        if not phones:
            if p in SIL_PHONES:
                if p == "spn":
                    word_idx += 1
                continue
            start_time = s
        if p not in SIL_PHONES:
            phones.append(p)
            end_time = e
            end_idx = len(phones)
            phone_count += 1
            if word_idx < len(words) and abs(words[word_idx][1] - e) < 1e-9:
                phones_per_word.append(phone_count)
                phone_count = 0
                word_idx += 1
        else:
            phones.append(p)
            phones_per_word.append(1)
            phone_count = 0
            if p == "spn":
                word_idx += 1
        durations.append(int(
            np.round(e * sampling_rate / hop_length)
            - np.round(s * sampling_rate / hop_length)))

    trim_len = len(phones[end_idx:])
    if trim_len:
        phones_per_word = phones_per_word[:-trim_len]
    phones = phones[:end_idx]
    durations = durations[:end_idx]
    assert len(phones) == sum(phones_per_word), (phones, phones_per_word)
    return phones, durations, start_time, end_time, phones_per_word


class Preprocessor:
    def __init__(self, preprocess_config, model_config, train_config, device=None):
        pp = preprocess_config["preprocessing"]
        self.config = preprocess_config
        self.in_dir = preprocess_config["path"]["raw_path"]
        self.out_dir = preprocess_config["path"]["preprocessed_path"]
        self.val_size = pp["val_size"]
        self.sampling_rate = pp["audio"]["sampling_rate"]
        self.hop_length = pp["stft"]["hop_length"]
        self.multi_speaker = model_config["multi_speaker"]
        self.sort_data = pp["sort_data"]
        self.sub_divide_word = pp["text"]["sub_divide_word"]
        self.max_phoneme_num = pp["text"]["max_phoneme_num"]
        self.beta_binomial_scaling = pp["aligner"]["beta_binomial_scaling_factor"]
        self.pitch_phoneme_averaging = pp["pitch"]["feature"] == "phoneme_level"
        # 'nccf' (default, Praat-family) or 'dio' (the reference's
        # pyworld DIO+StoneMask family, `preprocessor/preprocessor.py:294`);
        # cross-tracker drift is bounded in tests/test_f0_agreement.py
        self.pitch_tracker = pp["pitch"].get("tracker", "nccf")
        if self.pitch_tracker not in ("nccf", "dio"):
            raise ValueError(
                f"unknown preprocessing.pitch.tracker "
                f"{self.pitch_tracker!r}: expected 'nccf' or 'dio'")
        self.energy_phoneme_averaging = pp["energy"]["feature"] == "phoneme_level"
        self.pitch_normalization = pp["pitch"]["normalization"]
        self.energy_normalization = pp["energy"]["normalization"]
        self.n_mels = pp["mel"]["n_mel_channels"]
        self.stft = TacotronSTFT(
            pp["stft"]["filter_length"], pp["stft"]["hop_length"],
            pp["stft"]["win_length"], pp["mel"]["n_mel_channels"],
            pp["audio"]["sampling_rate"], pp["mel"]["mel_fmin"],
            pp["mel"]["mel_fmax"], device=device)
        self.speaker_emb = None
        if self.multi_speaker and pp.get("speaker_embedder", "none") != "none":
            from ..models.speaker_embedder import PreDefinedEmbedder
            self.speaker_emb = PreDefinedEmbedder(preprocess_config, device=device)
        self.seconds = collections.Counter()

    @contextlib.contextmanager
    def _timed(self, part):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[part] += time.perf_counter() - t0

    # --- per-utterance ------------------------------------------------------

    def process_utterance(self, speaker, basename, save_speaker_emb=False):
        wav_path = os.path.join(self.in_dir, speaker, f"{basename}.wav")
        text_path = os.path.join(self.in_dir, speaker, f"{basename}.lab")
        tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                               f"{basename}.TextGrid")

        with self._timed("alignment and priors"):
            textgrid = read_textgrid(tg_path)
            phones, duration, start, end, phones_per_word = get_alignment(
                textgrid.get_tier_by_name("phones"),
                textgrid.get_tier_by_name("words"),
                self.sampling_rate, self.hop_length)
            if self.sub_divide_word:
                phones_per_word = word_level_subdivision(
                    phones_per_word, self.max_phoneme_num)
        text = "{" + " ".join(phones) + "}"
        if start >= end:
            return None

        with self._timed("reads"):
            wav, _ = load_wav(wav_path, self.sampling_rate)
        with self._timed("speaker embedding"):
            spker_embed = (self.speaker_emb(wav) if save_speaker_emb else None)
        wav = wav[int(self.sampling_rate * start):
                  int(self.sampling_rate * end)].astype(np.float32)

        with open(text_path) as f:
            raw_text = f.readline().strip("\n")

        track = extract_f0 if self.pitch_tracker == "nccf" else extract_f0_dio
        with self._timed("F0"):
            pitch = track(wav, self.sampling_rate, self.hop_length)
        pitch = pitch[:sum(duration)]
        if np.sum(pitch != 0) <= 1:
            return None

        with self._timed("mel and energy"):
            mel, energy = self.stft.get_mel_from_wav(wav)
        mel = mel[:, :sum(duration)]
        energy = np.asarray(energy[:sum(duration)], dtype=np.float64)

        if self.pitch_phoneme_averaging:
            pitch = interpolate_unvoiced(pitch)
            pos = 0
            for i, d in enumerate(duration):
                pitch[i] = np.mean(pitch[pos:pos + d]) if d > 0 else 0.0
                pos += d
            pitch = pitch[:len(duration)]
        if self.energy_phoneme_averaging:
            pos = 0
            for i, d in enumerate(duration):
                energy[i] = np.mean(energy[pos:pos + d]) if d > 0 else 0.0
                pos += d
            energy = energy[:len(duration)]

        with self._timed("alignment and priors"):
            attn_prior = beta_binomial_prior(
                mel.shape[1], len(duration), self.beta_binomial_scaling)

        def save(kind, arr):
            np.save(os.path.join(self.out_dir, kind,
                                 f"{speaker}-{kind}-{basename}.npy"), arr)

        with self._timed("writes"):
            save("mel", mel.T)
            save("pitch", pitch)
            save("energy", energy)
            save("duration", duration)
            save("phones_per_word", phones_per_word)
            save("attn_prior", attn_prior)

        return (
            "|".join([basename, speaker, text, raw_text]),
            self.remove_outlier(pitch),
            self.remove_outlier(energy),
            mel.shape[1],
            np.min(mel, axis=1),
            np.max(mel, axis=1),
            spker_embed,
        )

    # --- corpus-level -------------------------------------------------------

    def build_from_path(self):
        for d in ("mel", "pitch", "energy", "duration", "phones_per_word",
                  "attn_prior", "spker_embed"):
            os.makedirs(os.path.join(self.out_dir, d), exist_ok=True)

        val_prior = self._val_prior_names()
        out, train, val = [], [], []
        filtered_out = set()
        n_frames = 0
        max_seq_len = -1
        mel_frame_len = {}
        mel_min = np.full(self.n_mels, np.inf)
        mel_max = np.full(self.n_mels, -np.inf)
        pitch_scaler, energy_scaler = RunningScaler(), RunningScaler()
        speakers = {}
        spk_embeds = {}

        spk_dirs = sorted(
            p for p in os.listdir(self.in_dir)
            if os.path.isdir(os.path.join(self.in_dir, p)))
        for i, speaker in enumerate(spk_dirs):
            speakers[speaker] = i
            for wav_name in sorted(os.listdir(
                    os.path.join(self.in_dir, speaker))):
                if not wav_name.endswith(".wav"):
                    continue
                basename = wav_name[:-4]
                tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                                       f"{basename}.TextGrid")
                if not os.path.exists(tg_path):
                    continue
                ret = self.process_utterance(
                    speaker, basename, self.speaker_emb is not None)
                if ret is None:
                    filtered_out.add(basename)
                    continue
                info, pitch, energy, n, m_min, m_max, spker_embed = ret
                if val_prior is not None:
                    (val if basename in val_prior else train).append(info)
                else:
                    out.append(info)
                if len(pitch) > 0:
                    pitch_scaler.partial_fit(pitch)
                if len(energy) > 0:
                    energy_scaler.partial_fit(energy)
                if spker_embed is not None:
                    spk_embeds.setdefault(speaker, []).append(spker_embed)
                mel_min = np.minimum(mel_min, m_min)
                mel_max = np.maximum(mel_max, m_max)
                max_seq_len = max(max_seq_len, n)
                n_frames += n
                mel_frame_len[basename] = n

            if speaker in spk_embeds:
                np.save(os.path.join(self.out_dir, "spker_embed",
                                     f"{speaker}-spker_embed.npy"),
                        np.mean(spk_embeds[speaker], axis=0),
                        allow_pickle=False)

        pitch_mean = pitch_scaler.mean if self.pitch_normalization else 0.0
        pitch_std = pitch_scaler.scale if self.pitch_normalization else 1.0
        energy_mean = energy_scaler.mean if self.energy_normalization else 0.0
        energy_std = energy_scaler.scale if self.energy_normalization else 1.0

        with self._timed("writes"):
            pitch_min, pitch_max = self._normalize_dir("pitch", pitch_mean, pitch_std)
            energy_min, energy_max = self._normalize_dir(
                "energy", energy_mean, energy_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump({
                "pitch": [float(pitch_min), float(pitch_max),
                          float(pitch_mean), float(pitch_std)],
                "energy": [float(energy_min), float(energy_max),
                           float(energy_mean), float(energy_std)],
                "spec_min": mel_min.tolist(),
                "spec_max": mel_max.tolist(),
                "max_seq_len": max_seq_len,
            }, f)

        if val_prior is not None:
            random.shuffle(train)
        else:
            random.shuffle(out)
            train, val = out[self.val_size:], out[:self.val_size]
        if self.sort_data:
            train.sort(key=lambda x: mel_frame_len[x.split("|")[0]])
            val.sort(key=lambda x: mel_frame_len[x.split("|")[0]])

        def write_list(name, rows):
            with open(os.path.join(self.out_dir, name), "w",
                      encoding="utf-8") as f:
                for m in rows:
                    f.write(m + "\n")

        write_list("train.txt", train)
        write_list("val.txt", val)
        write_list("filtered_out.txt", sorted(filtered_out))
        print(f"Total time: "
              f"{n_frames * self.hop_length / self.sampling_rate / 3600} hours")

        if spk_embeds:
            # t-SNE panel of per-utterance embeddings, colored by gender
            # when the corpus ships a VCTK-style speaker-info.txt
            # (`preprocessor/preprocessor.py:219-224,481-489`)
            print("Plot speaker embedding...")
            try:
                from ..utils.plotting import plot_embedding
                embs, ids = [], []
                for speaker, vecs in spk_embeds.items():
                    embs += [np.asarray(v).reshape(-1) for v in vecs]
                    ids += [speaker] * len(vecs)
                plot_embedding(
                    self.out_dir, np.stack(embs), ids,
                    self._speaker_genders(), filename="spker_embed_tsne.png")
            except Exception as e:
                print(f"speaker-embedding plot skipped ({e})")
        return train, val

    def _speaker_genders(self, speaker_path="speaker-info.txt"):
        """VCTK-style 'ID AGE GENDER ...' table; empty dict when absent
        (plot defaults every speaker to one class)."""
        import re
        path = os.path.join(self.config["path"].get("corpus_path", ""),
                            speaker_path)
        genders = {}
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    if "ID" in line:
                        continue
                    parts = re.sub(" +", " ", line.strip()).split(" ")
                    if len(parts) >= 3:
                        genders[parts[0]] = parts[2]
        return genders

    def _val_prior_names(self):
        path = os.path.join(self.out_dir, "val.txt")
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            return {line.split("|")[0] for line in f if line.strip()}

    def _normalize_dir(self, kind, mean, std):
        d = os.path.join(self.out_dir, kind)
        vmin, vmax = np.inf, -np.inf
        for filename in os.listdir(d):
            path = os.path.join(d, filename)
            values = (np.load(path) - mean) / std
            np.save(path, values)
            if values.size:
                vmin = min(vmin, values.min())
                vmax = max(vmax, values.max())
        return vmin, vmax

    def remove_outlier(self, values):
        """IQR filter (`preprocessor/preprocessor.py:458-466`)."""
        values = np.asarray(values)
        if values.size == 0:
            return values
        p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
        lower = p25 - 1.5 * (p75 - p25)
        upper = p75 + 1.5 * (p75 - p25)
        return values[np.logical_and(values > lower, values < upper)]
