"""Manual GPU benchmark: serving throughput through the port's TTSPipeline,
the counterpart of tests/bench_serving.py.

Times the whole host -> wav path (bucketing and padding on the host, the
acoustic model and vocoder enqueued on the card, int16 on the card, the
copy to the host, the trim per utterance) for a batch of B
`example_text_batch(B, 64, 24)` utterances on the flagship shallow model
(random weights from a seed), and reports utterances/s.  Variants: `call`
(one call a batch, the mel copied too), `nomel` (`return_mel=False`) and
`stream` (`pipe.stream`, two batches in flight, no mel).  Best of 3 rounds
of 20 batches after a warm-up call; each call ends in its copy to the host.

    python3 tests/bench_torch_serving.py [B] [call|nomel|stream]
    python3 tests/bench_torch_serving.py 2 stream --device cpu --tiny --iters 2

It runs on the card unless `--device cpu` is given.  `--tiny` serves the
tiny flagship model, whose 16 positions sit below every bucket: its
requests (15 phones at most) are served unbucketed.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from mixgantts_tpu_torch.bench import card_line, full_fp32  # noqa: E402
from mixgantts_tpu_torch.flagship import (  # noqa: E402
    TINY_REQUEST, example_text_batch, flagship_model,
)
from mixgantts_tpu_torch.models.vocoder import get_vocoder  # noqa: E402
from mixgantts_tpu_torch.pipeline import TTSPipeline  # noqa: E402
from mixgantts_tpu_torch.utils.tools import resolve_device  # noqa: E402

VARIANTS = ("call", "nomel", "stream")


def main(B=8, variant="call", device=None, tiny=False, iters=20, rounds=3):
    """Print the card, the shapes and the readings; return them as a dict
    (ms_batch, utt_s, ms_utt, realtime, bucket)."""
    device = resolve_device(device)
    full_fp32()
    torch.manual_seed(0)
    model, (pre, cfg, _) = flagship_model("shallow", tiny=tiny, device=device)
    P, W = TINY_REQUEST if tiny else (64, 24)
    if tiny:
        cfg["tpu"].update(length_buckets=[], phone_buckets=[])
    pipe = TTSPipeline(model, get_vocoder(cfg, device=device, seed=0), pre, cfg)
    batch = example_text_batch(B=B, P=P, W=W, rng=0)
    return_mel = variant == "call"

    wavs, mel, _ = pipe(batch)   # warm-up (on the card, the kernels' build)
    bucket = mel.shape[1]
    best = float("inf")
    for _ in range(rounds):
        start = time.perf_counter()
        if variant == "stream":
            for wavs, _, _ in pipe.stream([batch] * iters, return_mel=False):
                pass
        else:
            for _ in range(iters):
                wavs, _, _ = pipe(batch, return_mel=return_mel)
        best = min(best, (time.perf_counter() - start) / iters)
    audio_s = sum(len(w) for w in wavs) / pre["preprocessing"]["audio"]["sampling_rate"]
    print(card_line() if device.type == "cuda" else "device cpu: plumbing only, no device metric")
    print(f"device={device} torch {torch.__version__} B={B} P={P} bucket_T={bucket} "
          f"return_mel={return_mel} variant={variant}")
    print(f"pipeline {variant}: {best * 1e3:8.3f} ms/batch  ({B / best:,.1f} utt/s, "
          f"{best / B * 1e3:.3f} ms/utt, {audio_s / best:,.1f}x realtime on generated audio)",
          flush=True)
    return {"ms_batch": best * 1e3, "utt_s": B / best, "ms_utt": best / B * 1e3,
            "realtime": audio_s / best, "bucket": bucket}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("B", nargs="?", type=int, default=8)
    parser.add_argument("variant", nargs="?", choices=VARIANTS, default="call")
    parser.add_argument("--device", default=None, help="default cuda")
    parser.add_argument("--tiny", action="store_true", help="the tiny flagship model")
    parser.add_argument("--iters", type=int, default=20, help="batches a round")
    args = parser.parse_args()
    main(args.B, args.variant, args.device, args.tiny, args.iters)
