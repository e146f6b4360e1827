"""The long-horizon drive's corpus and configurations, on the port's side
(`tests/train_horizon_torch.py` imports this; neither imports JAX, flax
or `mixgantts_tpu`, so both run where there is no JAX).

Copies, value for value, of what `tests/train_horizon.py` takes from the
JAX side's test files: `PREPROCESS_CONFIG` and `make_corpus`
(`tests/test_data_pipeline.py`), `TINY_MODEL_YAML` and `TINY_TRAIN_YAML`
(`tests/test_cli.py`) and `make_multispeaker_corpus`
(`tests/test_multispeaker_e2e.py`), with the same numpy draws, written
through the port's `audio/wav.py` and `data/textgrid.py`; and the
horizon's own changes to them (`train_horizon.py:86-130`):
`write_corpus`, `write_configs`.
"""

import copy
import os

import numpy as np
import yaml

from mixgantts_tpu_torch.audio.wav import save_wav
from mixgantts_tpu_torch.data.textgrid import IntervalTier, write_textgrid

SR = 22050
HOP = 64
N_FFT = 256

PREPROCESS_CONFIG = {
    "dataset": "TestCorpus",
    "path": {},
    "preprocessing": {
        "sort_data": True,
        "val_size": 1,
        "speaker_embedder": "none",
        "text": {"text_cleaners": ["english_cleaners"], "language": "en",
                 "sub_divide_word": True, "max_phoneme_num": 7},
        "audio": {"sampling_rate": SR, "max_wav_value": 32768.0},
        "stft": {"filter_length": N_FFT, "hop_length": HOP,
                 "win_length": N_FFT},
        "mel": {"n_mel_channels": 20, "mel_fmin": 0, "mel_fmax": 8000},
        "pitch": {"feature": "phoneme_level", "normalization": True},
        "energy": {"feature": "phoneme_level", "normalization": True},
        "aligner": {"beta_binomial_scaling_factor": 1.0},
    },
}

TINY_MODEL_YAML = {
    "transformer": {
        "encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 32,
        "decoder_layer": 1, "decoder_head": 2, "decoder_hidden": 32,
        "conv_filter_size": 64, "conv_kernel_size": 3,
        "encoder_dropout": 0.2, "decoder_dropout": 0.2,
        "encoder_window_size": 4, "ffn_padding": "SAME", "ffn_act": "gelu",
    },
    "denoiser": {
        "denoiser_hidden": 32, "denoiser_dropout": 0.2,
        "residual_layers": 2, "residual_channels": 16,
        "noise_schedule_naive": "vpsde", "timesteps": 2,
        "shallow_timesteps": 1, "min_beta": 0.1, "max_beta": 40,
        "s": 0.008, "keep_bins": 20,
    },
    "discriminator": {
        "n_layer": 3, "n_uncond_layer": 2, "n_cond_layer": 2,
        "n_channels": [8, 16, 32, 16, 1], "kernel_sizes": [3, 5, 5, 5, 3],
        "strides": [1, 2, 2, 1, 1],
    },
    "variance_predictor": {"filter_size": 16, "kernel_size": 3,
                           "dropout": 0.5},
    "variance_embedding": {"pitch_quantization": "linear",
                           "energy_quantization": "linear", "n_bins": 16},
    "multi_speaker": False,
    "external_speaker_dim": 512,
    "max_seq_len": 256,
    "vocoder": {"model": "HiFi-GAN", "speaker": "LJSpeech"},
    "tpu": {"compute_dtype": "float32",
            "length_buckets": [64, 128, 256], "phone_buckets": [8, 16, 32]},
}

TINY_TRAIN_YAML = {
    "path": {},
    "optimizer": {
        "batch_size": 2, "batch_size_shallow": 2, "betas": [0.5, 0.9],
        "gamma": 0.999, "grad_clip_thresh": 1, "grad_acc_step": 1,
        "init_lr_G": 0.0001, "init_lr_D": 0.0002,
    },
    "optimizer_fs2": {
        "betas": [0.9, 0.98], "eps": 1e-9, "weight_decay": 0.0,
        "warm_up_step": 4, "anneal_steps": [100], "anneal_rate": 0.3,
    },
    "loss": {
        "adv_loss_mode": "lsgan", "noise_loss": "l1", "dur_loss": "mse",
        "pitch_loss": "l1", "lambda_d": 0.1, "lambda_p": 0.1,
        "lambda_e": 0.1, "lambda_fm": 10.0, "lambda_fm_shallow": 0.001,
    },
    "step": {
        "total_step_aux": 4, "total_step_naive": 4, "total_step_shallow": 4,
        "log_step": 2, "synth_step": 1000, "val_step": 1000, "save_step": 2,
    },
    "aligner": {
        "helper_type": "dga", "ctc_step": 0, "ctc_weight_start": 1.0,
        "ctc_weight_end": 1.0, "guided_sigma": 0.4, "guided_lambda": 1.0,
        "guided_weight": 1.0,
    },
}

LEXICON = "hello HH AH0 L OW1\nworld W ER1 L D\n"


def _utterance(raw, tg_dir, name, dur, hz, rng):
    """One sine-tone utterance of "hello world" (HH AH0 | L OW1 | sil)
    with its TextGrid."""
    n = int(SR * dur)
    t = np.arange(n) / SR
    wav = (0.4 * np.sin(2 * np.pi * hz * t)
           + 0.01 * rng.randn(n)).astype(np.float32)
    save_wav(os.path.join(raw, f"{name}.wav"), wav, SR)
    with open(os.path.join(raw, f"{name}.lab"), "w") as f:
        f.write("hello world")
    q = dur / 5.0
    phones = [(0.0, q, "HH"), (q, 2 * q, "AH0"),
              (2 * q, 3 * q, "L"), (3 * q, 4 * q, "OW1"),
              (4 * q, 5 * q, "sil")]
    words = [(0.0, 2 * q, "hello"), (2 * q, 4 * q, "world"),
             (4 * q, 5 * q, "")]
    write_textgrid(
        os.path.join(tg_dir, f"{name}.TextGrid"),
        [IntervalTier("words", words), IntervalTier("phones", phones)],
        xmax=dur)


def _speaker_dirs(root, spk):
    raw = os.path.join(root, "raw_data", spk)
    tg_dir = os.path.join(root, "preprocessed", "TextGrid", spk)
    os.makedirs(raw, exist_ok=True)
    os.makedirs(tg_dir, exist_ok=True)
    return raw, tg_dir


def make_corpus(root, n_utts=5):
    """Sine-tone utterances with 4 phones + a word boundary structure."""
    raw, tg_dir = _speaker_dirs(root, "spk0")
    rng = np.random.RandomState(0)
    for k in range(n_utts):
        _utterance(raw, tg_dir, f"utt{k}", 0.30 + 0.1 * k, 120 + 40 * k, rng)


def make_multispeaker_corpus(root, n_speakers=2, n_utts=4):
    """`n_speakers` speakers of `n_utts` utterances, each speaker in its own
    F0 register."""
    rng = np.random.RandomState(0)
    for s in range(n_speakers):
        raw, tg_dir = _speaker_dirs(root, str(s))
        for k in range(n_utts):
            _utterance(raw, tg_dir, f"utt{k}", 0.30 + 0.1 * k, 100 + 60 * s + 40 * k, rng)


def write_corpus(ws, multispeaker):
    """The horizon's corpus under `ws` (24 utterances of one speaker, or 3
    speakers x 8) and its lexicon."""
    os.makedirs(ws)
    if multispeaker:
        make_multispeaker_corpus(ws, n_speakers=3, n_utts=8)
    else:
        make_corpus(ws, n_utts=24)
    with open(f"{ws}/lexicon.txt", "w") as f:
        f.write(LEXICON)


def write_configs(ws, multispeaker, step):
    """`ws/config/TestCorpus/`: the tiny configs with the horizon's changes
    (the learned speaker table, embedder "none", for the multi-speaker run;
    steps_per_call 8; max_seq_len 768 and length buckets up to 768 for
    utterances of up to ~2.6 s; the paths under `ws`) and `step` as the
    train config's step block."""
    pre = copy.deepcopy(PREPROCESS_CONFIG)
    pre["path"] = {"corpus_path": ws,
                   "lexicon_path": f"{ws}/lexicon.txt",
                   "raw_path": f"{ws}/raw_data",
                   "preprocessed_path": f"{ws}/preprocessed"}
    if multispeaker:
        pre["preprocessing"]["speaker_embedder"] = "none"
    model = copy.deepcopy(TINY_MODEL_YAML)
    model["multi_speaker"] = multispeaker
    model["tpu"]["steps_per_call"] = 8
    model["max_seq_len"] = 768
    model["tpu"]["length_buckets"] = [96, 192, 384, 768]
    train = copy.deepcopy(TINY_TRAIN_YAML)
    train["path"] = {k: f"{ws}/output/{k[:-5]}/TestCorpus"
                     for k in ("ckpt_path", "log_path", "result_path")}
    train["step"] = dict(step)
    cfg = f"{ws}/config/TestCorpus"
    os.makedirs(cfg, exist_ok=True)
    for name, c in (("preprocess.yaml", pre), ("model.yaml", model), ("train.yaml", train)):
        with open(f"{cfg}/{name}", "w") as f:
            yaml.dump(c, f)
