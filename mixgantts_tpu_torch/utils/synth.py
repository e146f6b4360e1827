"""Result files of the synthesis CLI (`mixgantts_tpu/utils/synth.py::
write_results`): `{basename}.wav` and `{basename}.png` per utterance in
`result_path/<restore_step>/`.  Where matplotlib does not import, the wavs
are written, the figures skipped, and a warning says so (on stderr, once
per process under Python's default warning filter)."""

import os
import warnings

from ..audio.wav import save_wav
from .plotting import plot_mel


def _can_plot():
    try:
        import matplotlib  # noqa: F401
        return True
    except ImportError:
        warnings.warn("matplotlib is not installed: writing wavs without mel figures",
                      stacklevel=3)
        return False


def write_results(args, basenames, mel_preds, mel_lens, wavs, model_config,
                  preprocess_config, path):
    """Write the figures and wavs of synthesized mels [B, T, M] and int16
    waveforms; returns the wav paths, in order."""
    teacher_forced_tag = "_teacher_forced" if getattr(args, "teacher_forced", False) else ""
    out_dir = os.path.join(path, str(args.restore_step))
    os.makedirs(out_dir, exist_ok=True)

    def tag_for(basename):
        if model_config["multi_speaker"] and getattr(args, "mode", "") == "single":
            return f"{basename}_{args.speaker_id}{teacher_forced_tag}"
        return f"{basename}{teacher_forced_tag}"

    if _can_plot():
        from matplotlib import pyplot as plt
        for i, basename in enumerate(basenames):
            mel_len = int(mel_lens[i])
            fig = plot_mel([mel_preds[i, :mel_len].T], ["Synthetized Spectrogram"])
            fig.savefig(os.path.join(out_dir, f"{tag_for(basename)}.png"))
            plt.close(fig)

    sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
    paths = []
    for wav, basename in zip(wavs, basenames):
        paths.append(os.path.join(out_dir, f"{tag_for(basename)}.wav"))
        save_wav(paths[-1], wav, sr)
    return paths
