"""Corpus -> raw_data preparation CLI (`mixgantts_tpu/cli/prepare_align.py`;
parity: `prepare_align.py:7-25`): LJSpeech's metadata.csv or AISHELL3's
content.txt -> per-speaker peak-normalised int16 wavs and .lab transcripts
under `path.raw_path`, for the aligner.  Host numpy; like the port's other
entry points it runs where cuda is, unless the caller passes the CPU.

    python -m mixgantts_tpu_torch.cli.prepare_align --dataset LJSpeech
"""

import argparse

from ..config import get_configs_of
from ..data import aishell3, ljspeech
from ..utils.tools import resolve_device


def cli(argv=None, device=None):
    """Parse `argv` (default sys.argv) and prepare the dataset's corpus.
    `device` (default cuda; raises where there is none) is checked only:
    nothing here runs on a device."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True, help="name of dataset")
    args = parser.parse_args(argv)
    resolve_device(device)
    config, _, _ = get_configs_of(args.dataset)
    if args.dataset == "LJSpeech":
        ljspeech.prepare_align(config)
    elif args.dataset == "AISHELL3":
        aishell3.prepare_align(config)
    else:
        raise ValueError(f"unknown dataset {args.dataset!r}")


if __name__ == "__main__":
    cli()
