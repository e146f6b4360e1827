"""Mel and attention figures (`mixgantts_tpu/utils/plotting.py`:
`plot_mel`, `plot_multi_attn`).  matplotlib is imported inside the
functions, so the port imports where it is absent."""

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


def plot_multi_attn(data, titles=None):
    """Attention maps per head; data: list of [n_heads, P, T] arrays.  One
    figure per array (the figure itself for a list of one)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    figs = []
    for attn in data:
        attn = np.asarray(attn)
        fig, axes = plt.subplots(attn.shape[0], 1, squeeze=False, figsize=(6, 4 * attn.shape[0]))
        for j in range(attn.shape[0]):
            im = axes[j][0].imshow(attn[j], origin="lower", aspect="auto")
            fig.colorbar(im, ax=axes[j][0])
        fig.tight_layout()
        figs.append(fig)
    return figs[0] if len(figs) == 1 else figs
