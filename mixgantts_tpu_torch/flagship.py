"""The flagship model and request of the benchmarks (`__graft_entry__.py`'s
`_flagship_model` and `_example_text_batch`, copied): LJSpeech-scale
synthesis from the packaged configs, and a seeded text batch.

    model, (pre, cfg, train) = flagship_model("shallow", device="cuda")
    batch = example_text_batch(B=1, P=64, W=24, rng=0)   # numpy, int64
"""

import numpy as np

from .config import NormStats, get_configs_of
from .models.mixgantts import MixGANTTS
from .utils.tools import resolve_device

# the phone and word slots of a request that fits the tiny model's
# 16-position tables: at most 3 phones a word, so at most 15 phones
TINY_REQUEST = (16, 5)


def flagship_model(mode="shallow", tiny=False, device=None):
    """(model, (preprocess_config, model_config, train_config)): the
    LJSpeech configs' MixGAN-TTS of `mode` with the default statistics, on
    `device` (default cuda; raises where there is none), its parameters
    drawn from torch's default generator.  `tiny` shrinks it as the JAX
    package's multi-device dryrun does (one encoder and decoder layer,
    hidden 16, a one-layer denoiser of 8 channels, 16 positions)."""
    preprocess_config, model_config, train_config = get_configs_of("LJSpeech")
    stats = NormStats.default(
        n_mels=preprocess_config["preprocessing"]["mel"]["n_mel_channels"])
    if tiny:
        t = model_config["transformer"]
        t.update(encoder_layer=1, decoder_layer=1, encoder_hidden=16,
                 conv_filter_size=32, conv_kernel_size=3)
        model_config["denoiser"].update(
            residual_layers=1, residual_channels=8, denoiser_hidden=16)
        model_config["variance_predictor"].update(filter_size=16)
        model_config["max_seq_len"] = 16
    model = MixGANTTS.from_configs(mode, preprocess_config, model_config, stats,
                                   device=resolve_device(device))
    return model, (preprocess_config, model_config, train_config)


def example_text_batch(B=1, P=32, W=12, rng=0):
    """B utterances of W words, 1-3 phones a word, phone ids in [1, 300),
    drawn from `np.random.RandomState(rng)` in the JAX helper's order, so
    that a seed gives its values (here as int64)."""
    r = np.random.RandomState(rng)
    wb = np.zeros((B, W), np.int64)
    counts = r.randint(1, 4, (B, W))
    wb[:, :] = counts
    src_w_lens = np.full((B,), W, np.int64)
    # make phones-per-word sum to the text length
    src_lens = wb.sum(-1).astype(np.int64)
    texts = np.zeros((B, P), np.int64)
    for b in range(B):
        texts[b, :src_lens[b]] = r.randint(1, 300, src_lens[b])
    return dict(
        speakers=np.zeros((B,), np.int64),
        texts=texts,
        src_lens=src_lens,
        word_boundaries=wb,
        src_w_lens=src_w_lens,
    )
