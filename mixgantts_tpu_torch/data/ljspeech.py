"""(A copy of `mixgantts_tpu/data/ljspeech.py`.) LJSpeech corpus preparation
for MFA alignment (parity: `preprocessor/ljspeech.py:11-38`): metadata.csv
-> per-speaker raw_data wav (peak-normalized int16) + cleaned .lab
transcript."""

import os

import numpy as np

from ..audio.wav import load_wav, save_wav
from ..text import _clean_text


def prepare_align(config):
    in_dir = config["path"]["corpus_path"]
    out_dir = config["path"]["raw_path"]
    sampling_rate = config["preprocessing"]["audio"]["sampling_rate"]
    max_wav_value = config["preprocessing"]["audio"]["max_wav_value"]
    cleaners = config["preprocessing"]["text"]["text_cleaners"]
    speaker = "LJSpeech"
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            base_name = parts[0]
            text = _clean_text(parts[2], cleaners)
            wav_path = os.path.join(in_dir, "wavs", f"{base_name}.wav")
            if not os.path.exists(wav_path):
                continue
            os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
            wav, _ = load_wav(wav_path, sampling_rate)
            wav = wav / max(np.max(np.abs(wav)), 1e-9) * max_wav_value
            save_wav(os.path.join(out_dir, speaker, f"{base_name}.wav"),
                     wav.astype(np.int16), sampling_rate)
            with open(os.path.join(out_dir, speaker, f"{base_name}.lab"),
                      "w") as f1:
                f1.write(text)
