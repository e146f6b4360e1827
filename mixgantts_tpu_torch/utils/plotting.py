"""Mel figures (`mixgantts_tpu/utils/plotting.py::plot_mel`).  matplotlib
is imported inside the function, so the port imports where it is absent."""

import numpy as np


def plot_mel(data, titles=None):
    """Stacked mel-spectrogram panels; data: list of [n_mels, T] arrays."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, axes = plt.subplots(len(data), 1, squeeze=False, figsize=(8, 2 * len(data)))
    if titles is None:
        titles = [None] * len(data)
    for i, mel in enumerate(data):
        axes[i][0].imshow(np.asarray(mel), origin="lower", aspect="auto")
        axes[i][0].set_ylim(0, np.asarray(mel).shape[0])
        axes[i][0].set_title(titles[i], fontsize="medium")
        axes[i][0].tick_params(labelsize="x-small", left=False, labelleft=False)
        axes[i][0].set_anchor("W")
    fig.tight_layout()
    return fig
