"""Sample synthesis for the train CLI's panels and the synthesis CLI
(`mixgantts_tpu/utils/synth.py`):
- `synth_one_sample`: the first utterance of a training batch as mel
  figures (the reverse trajectory, the coarse mel, the target), the
  word-to-phoneme attention figure, and the vocoded target and prediction;
- `synth_samples`: a teacher-forced output batch vocoded and written;
- `write_results`: `{basename}.wav` and `{basename}.png` per utterance in
  `result_path/<restore_step>/`.
Where matplotlib does not import, the figures are skipped (None, no png)
and a warning says so (on stderr, once per process under Python's default
warning filter)."""

import os
import warnings

import numpy as np
import torch

from ..audio.wav import save_wav
from ..models.vocoder import vocoder_infer
from .plotting import plot_mel, plot_multi_attn


def _can_plot():
    try:
        import matplotlib  # noqa: F401
        return True
    except ImportError:
        warnings.warn("matplotlib is not installed: no mel or attention figures",
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


def _np(x):
    return x.detach().float().cpu().numpy()


def _vocode(mel, vocoder, preprocess_config):
    """One [T, n_mels] numpy mel -> its int16 waveform."""
    device = next(vocoder.generator.parameters()).device
    return vocoder_infer(torch.from_numpy(np.ascontiguousarray(mel[None])).to(device),
                         vocoder, preprocess_config)[0]


def synth_one_sample(mode, batch, out, trace, vocoder, model_config, preprocess_config,
                     diffusion):
    """The first utterance of a host `batch`, the model's output `out` on it
    (the training branch in eval mode) and a fresh inference `trace`
    ([S+1, B, T, M] denormalised; None in aux mode, whose `out.mel_pred` is
    the diffuse trace) -> (figs, attn_fig, wav_reconstruction,
    wav_prediction, basename).  The wavs are None without a vocoder."""
    basename = batch["ids"][0]
    src_len = int(out.src_lens[0])
    mel_len = int(out.mel_lens[0])
    mel_target = np.asarray(batch["mels"])[0, :mel_len].T
    alignment = _np(out.attn[0][0, :, :mel_len, :src_len]).transpose(0, 2, 1)   # [H, P, T]

    if mode == "aux":
        mel_prediction = _np(diffusion.denorm_spec(out.mel_pred[0]))[0, :mel_len].T
        mels = [mel_prediction, mel_target]
        titles = ["Sampled Spectrogram", "GT"]
    else:
        mels = [_np(m)[0, :mel_len].T for m in trace]
        mel_prediction = mels[-1]
        titles = [f"T={t}" for t in range(len(mels) - 1, -1, -1)]
        if mode == "shallow" and out.coarse_mel is not None:
            mels.append(_np(out.coarse_mel)[0, :mel_len].T)
            titles.append("Coarse Spectrogram")
        mels.append(mel_target)
        titles.append("GT")

    figs = attn_fig = None
    if _can_plot():
        figs = plot_mel(mels, titles)
        attn_fig = plot_multi_attn([alignment])

    wav_reconstruction = wav_prediction = None
    if vocoder is not None:
        wav_reconstruction = _vocode(mel_target.T, vocoder, preprocess_config)
        wav_prediction = _vocode(mel_prediction.T, vocoder, preprocess_config)
    return figs, attn_fig, wav_reconstruction, wav_prediction, basename


def synth_samples(args, batch, out, vocoder, model_config, preprocess_config, path,
                  diffusion):
    """Vocode and write a synthesized output batch (aux mode: element 0 of
    its trace, denormalised); returns the wav paths."""
    mel_preds = out.mel_pred
    if args.model == "aux":
        mel_preds = diffusion.denorm_spec(out.mel_pred[0])
    mel_lens = _np(out.mel_lens).astype(np.int64)
    wavs = vocoder_infer(mel_preds, vocoder, preprocess_config, lengths=mel_lens)
    return write_results(args, batch["ids"], _np(mel_preds), mel_lens, wavs, model_config,
                         preprocess_config, path)
