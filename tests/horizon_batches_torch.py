"""Which batch each logged step of an aux drive trained on, beside two
runs' losses at that step.

The train CLI draws its batches from `--seed` 0 through the same
scheduler in every run (`cli/train.py::schedule_segments`, steps_per_call
8), over train.txt sorted by length.  Which utterances train.txt holds is
drawn anew by each run's preprocessing (one of the 24 is held out,
unseeded, as in the JAX package), so two runs' step n train on the same
batch only where their held-out utterances coincide, and otherwise on the
same bucket and on neighbours in length.  This script preprocesses the
drive's corpus on the CPU, puts the first run's held-out utterances
(`val_ids` in its JSON, where recorded) out of train.txt, replays the
scheduler from the `.npy` headers and prints, for every logged step: the
batch's frame bucket, its utterances and mel lengths, its place in its
segment, and each key's ratio between the two runs' logs; then the mean
postnet ratio by frame bucket, up to and after `--split`.

    python tests/horizon_batches_torch.py docs/horizon_torch.json docs/horizon_r04.json

It imports nothing of JAX, flax or `mixgantts_tpu`.
"""

import argparse
import glob
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import train_horizon_torch as horizon  # noqa: E402  (puts the repo on sys.path)


def hold_out(pp, val_ids):
    """Rewrite train.txt and val.txt of the preprocessed corpus `pp` with
    `val_ids` held out, train.txt sorted by mel length as the
    preprocessor sorts it."""
    lines = {}
    for name in ("train.txt", "val.txt"):
        with open(os.path.join(pp, name), encoding="utf-8") as f:
            lines.update((line.split("|", 1)[0], line) for line in f if line.strip())

    def frames(uid):
        (path,) = glob.glob(os.path.join(pp, "mel", f"*-mel-{uid}.npy"))
        return np.load(path, mmap_mode="r").shape[0]

    train = sorted((u for u in lines if u not in val_ids), key=frames)
    for name, ids in (("train.txt", train), ("val.txt", sorted(val_ids, key=frames))):
        with open(os.path.join(pp, name), "w", encoding="utf-8") as f:
            f.writelines(lines[u] for u in ids)


def batch_of_step(ws, steps, val_ids=None, k=8):
    """{step: batch facts} for steps 1..steps of the aux drive in `ws`,
    with `val_ids` held out (else this preprocessing's own draw)."""
    from mixgantts_tpu_torch.cli import train
    from mixgantts_tpu_torch.config import get_configs_of
    from mixgantts_tpu_torch.data.dataset import AcousticDataset
    drive = horizon.Drive(ws, device="cpu")
    block = horizon.step_block(steps, horizon.SHALLOW_STEPS, steps)
    drive.prepare(False, block)
    if val_ids is not None:
        hold_out(os.path.join(ws, "preprocessed"), val_ids)
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        pre, cfg, tc = get_configs_of("TestCorpus")
    finally:
        os.chdir(cwd)
    dataset = AcousticDataset("train.txt", "aux", pre, cfg, tc, sort=True, drop_last=True)
    stream = dataset.batches(group_size=train.GROUP_SIZE, shuffle=True, seed=0,
                             replayed=range(sys.maxsize))   # headers only
    next(b for b in stream if b is not None)   # the batch the run initialises on
    periods = [block["log_step"], block["synth_step"], block["val_step"], block["save_step"]]
    out, step, epoch = {}, 0, 0
    for event, payload in train.schedule_segments(stream, k, 1, steps, periods):
        if event == "epoch":
            epoch += 1
            continue
        for j, b in enumerate(payload):
            step += 1
            out[step] = {"bucket": int(b["mels"].shape[1]), "ids": list(b["ids"]),
                         "mel_lens": [int(n) for n in b["mel_lens"]],
                         "segment": f"{j + 1}/{len(payload)}", "epoch": epoch}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("run", help="a horizon JSON with aux_trajectory (the numerator)")
    parser.add_argument("reference", help="another one (the denominator)")
    parser.add_argument("--split", type=int, default=600, help="the step the means split at")
    args = parser.parse_args(argv)
    run, ref = (json.load(open(p)) for p in (args.run, args.reference))
    val_ids = run.get("val_ids")
    print(f"held out: {val_ids if val_ids is not None else 'not recorded; this draw'}")
    rows, ref = run["aux_trajectory"], ref["aux_trajectory"]
    with tempfile.TemporaryDirectory() as tmp:
        facts = batch_of_step(os.path.join(tmp, "ws"), int(rows[-1]["step"]), val_ids)
    by_bucket = {}
    keys = ("postnet", "mel", "pitch", "energy", "duration", "helper")
    for a, b in zip(rows, ref):
        s = int(a["step"])
        f = facts[s]
        ratios = {key: a[key] / b[key] for key in keys if b[key]}
        print(f"{s:5d} bucket {f['bucket']:4d} {f['ids']} {f['mel_lens']} segment "
              f"{f['segment']} epoch {f['epoch']}: "
              + " ".join(f"{key} {r:.2f}" for key, r in ratios.items()))
        by_bucket.setdefault((f["bucket"], s > args.split), []).append(ratios["postnet"])
    for (bucket, late), v in sorted(by_bucket.items()):
        print(f"bucket {bucket}, steps {'>' if late else '<='} {args.split}: postnet ratio "
              f"mean {np.mean(v):.3f} over {len(v)} logged steps")


if __name__ == "__main__":
    main()
