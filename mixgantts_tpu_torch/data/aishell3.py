"""(A copy of `mixgantts_tpu/data/aishell3.py`.) AISHELL3 corpus preparation
(parity: `preprocessor/aishell3.py:8-34`): content.txt (char pinyin pairs)
-> per-speaker raw_data wav + pinyin .lab."""

import os

import numpy as np

from ..audio.wav import load_wav, save_wav


def prepare_align(config):
    in_dir = config["path"]["corpus_path"]
    out_dir = config["path"]["raw_path"]
    sampling_rate = config["preprocessing"]["audio"]["sampling_rate"]
    max_wav_value = config["preprocessing"]["audio"]["max_wav_value"]
    for dataset in ["train", "test"]:
        print(f"Processing {dataset}ing set...")
        content = os.path.join(in_dir, dataset, "content.txt")
        if not os.path.isfile(content):
            continue
        with open(content, encoding="utf-8") as f:
            for line in f:
                wav_name, text = line.strip("\n").split("\t")
                speaker = wav_name[:7]
                # content.txt alternates hanzi and pinyin tokens
                text = text.split(" ")[1::2]
                wav_path = os.path.join(in_dir, dataset, "wav", speaker,
                                        wav_name)
                if not os.path.exists(wav_path):
                    continue
                os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
                wav, _ = load_wav(wav_path, sampling_rate)
                wav = wav / max(np.max(np.abs(wav)), 1e-9) * max_wav_value
                save_wav(os.path.join(out_dir, speaker, wav_name),
                         wav.astype(np.int16), sampling_rate)
                with open(os.path.join(out_dir, speaker,
                                       f"{wav_name[:11]}.lab"), "w") as f1:
                    f1.write(" ".join(text))
