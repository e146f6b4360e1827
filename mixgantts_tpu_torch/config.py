"""Config loading and dataset statistics (`mixgantts_tpu/config.py`): the
YAML configs per dataset and the statistics the model reads (the fields
of a preprocessed corpus's `stats.json`)."""

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import yaml

_PKG_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def get_configs_of(dataset, config_dir=None):
    """Load the (preprocess, model, train) config dicts of a dataset from
    `config_dir/<dataset>`, `./config/<dataset>`, then the packaged
    `configs/<dataset>`."""
    candidates = [os.path.join(config_dir, dataset)] if config_dir else []
    candidates += [os.path.join("./config", dataset),
                   os.path.join(_PKG_CONFIG_DIR, dataset)]
    for cand in candidates:
        if os.path.isdir(cand):
            break
    else:
        raise FileNotFoundError(f"no config dir found for dataset {dataset!r}")

    def load(name):
        with open(os.path.join(cand, name)) as f:
            return yaml.safe_load(f)

    return load("preprocess.yaml"), load("model.yaml"), load("train.yaml")


@dataclass(frozen=True)
class NormStats:
    """Dataset statistics from preprocessing (`stats.json`)."""

    pitch_min: float
    pitch_max: float
    pitch_mean: float
    pitch_std: float
    energy_min: float
    energy_max: float
    energy_mean: float
    energy_std: float
    spec_min: Tuple[float, ...]
    spec_max: Tuple[float, ...]
    max_seq_len: Optional[int] = None

    @classmethod
    def load(cls, preprocessed_path, n_mels=80):
        """The statistics in `preprocessed_path/stats.json`."""
        with open(os.path.join(preprocessed_path, "stats.json")) as f:
            stats = json.load(f)
        p, e = stats["pitch"], stats["energy"]
        return cls(
            pitch_min=float(p[0]), pitch_max=float(p[1]),
            pitch_mean=float(p[2]), pitch_std=float(p[3]),
            energy_min=float(e[0]), energy_max=float(e[1]),
            energy_mean=float(e[2]), energy_std=float(e[3]),
            spec_min=tuple(float(x) for x in stats["spec_min"][:n_mels]),
            spec_max=tuple(float(x) for x in stats["spec_max"][:n_mels]),
            max_seq_len=stats.get("max_seq_len"),
        )

    @classmethod
    def default(cls, n_mels=80):
        """Placeholder stats for tests and randomly initialised models."""
        return cls(
            pitch_min=-2.0, pitch_max=10.0, pitch_mean=200.0, pitch_std=50.0,
            energy_min=-1.5, energy_max=8.0, energy_mean=30.0, energy_std=20.0,
            spec_min=tuple([-12.0] * n_mels), spec_max=tuple([2.0] * n_mels),
            max_seq_len=1000,
        )

    @classmethod
    def load_or_default(cls, preprocessed_path, n_mels=80):
        """`load`, or the placeholder stats where the corpus has none."""
        try:
            return cls.load(preprocessed_path, n_mels)
        except (FileNotFoundError, KeyError, json.JSONDecodeError):
            return cls.default(n_mels)
