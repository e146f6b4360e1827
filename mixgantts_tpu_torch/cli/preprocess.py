"""Preprocess CLI (`mixgantts_tpu/cli/preprocess.py`; parity:
`preprocess.py:8-19`): the aligned corpus under `path.raw_path` and the
TextGrids under `<preprocessed_path>/TextGrid/` -> the features, priors,
speaker embeddings, stats.json, speakers.json and the train/val split
under `path.preprocessed_path` (`data.preprocessor.Preprocessor`).  The
DeepSpeaker embedder of a multi-speaker config runs on the device (cuda
unless the caller passes the CPU; the configs' `speaker_embedder_cuda` is
ignored, as the JAX package ignores it).

    python -m mixgantts_tpu_torch.cli.preprocess --dataset AISHELL3
"""

import argparse

from ..config import get_configs_of
from ..data.preprocessor import Preprocessor
from ..utils.tools import resolve_device


def cli(argv=None, device=None):
    """Parse `argv` (default sys.argv) and preprocess the dataset on
    `device` (default cuda; raises where there is none).  Returns the
    `Preprocessor` and its (train, val) metadata lines."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True, help="name of dataset")
    args = parser.parse_args(argv)
    device = resolve_device(device)
    preprocess_config, model_config, train_config = get_configs_of(args.dataset)
    pre = Preprocessor(preprocess_config, model_config, train_config, device=device)
    return pre, pre.build_from_path()


if __name__ == "__main__":
    cli()
