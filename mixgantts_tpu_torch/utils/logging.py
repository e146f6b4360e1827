"""TensorBoard logging with the reference's scalar tags and its console and
`log.txt` line (`mixgantts_tpu/utils/logging.py`).  The writer is
tensorboardX's or `torch.utils.tensorboard`'s, whichever imports; where
neither does, `get_writer` returns a `NullWriter`, which drops every
event, and the console and `log.txt` lines are written all the same."""

import warnings

import numpy as np

LOSS_KEYS = [
    "total_loss", "D_loss", "G_loss", "recon_loss", "fm_loss", "adv_loss",
    "mel_loss", "postnet_loss", "pitch_loss", "energy_loss",
    "duration_loss", "helper_loss",
]

MESSAGE_KEYS = [
    "total_loss", "D_loss", "adv_loss", "mel_loss", "postnet_loss",
    "pitch_loss", "energy_loss", "duration_loss", "helper_loss",
]


class NullWriter:
    """A SummaryWriter that drops every event."""

    def add_scalar(self, *args, **kwargs):
        pass

    add_figure = add_audio = add_scalar

    def close(self):
        pass


def get_writer(log_dir):
    """tensorboardX's SummaryWriter, else torch.utils.tensorboard's (which
    imports TensorFlow where that is installed), else a NullWriter."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return NullWriter()
    return SummaryWriter(log_dir)


def log(logger, step=None, losses=None, lr=None, figs=None, audio=None,
        sampling_rate=22050, tag=""):
    """The reference's TensorBoard events; figures that were not drawn
    (None, where matplotlib is absent) and missing audio are skipped, and
    audio the writer cannot encode is skipped with a warning."""
    if losses is not None:
        for key in LOSS_KEYS:
            logger.add_scalar(f"Loss/{key}", float(losses[key]), step)
    if lr is not None:
        logger.add_scalar("Training/learning_rate", lr, step)
    if figs is not None:
        logger.add_figure(tag, figs, step)
    if audio is not None:
        audio = np.asarray(audio, dtype=np.float64)
        try:
            logger.add_audio(tag, audio / (np.abs(audio).max() + 1e-9), step,
                             sample_rate=sampling_rate)
        except ImportError as e:   # tensorboardX encodes audio with soundfile
            warnings.warn(f"TensorBoard audio skipped: {e}", stacklevel=2)


def loss_message(step, total_step, losses):
    """The reference's console and log.txt line (`train.py:189-199`)."""
    vals = [float(losses[k]) for k in MESSAGE_KEYS]
    return (
        f"Step {step}/{total_step}, "
        "Total Loss: {:.4f}, D_loss: {:.4f}, adv_loss: {:.4f}, "
        "mel_loss: {:.4f}, postnet_loss: {:.4f}, pitch_loss: {:.4f}, "
        "energy_loss: {:.4f}, duration_loss: {:.4f}, helper_loss:{:.4f}"
        .format(*vals))
