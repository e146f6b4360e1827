"""Mel and attention figures (`mixgantts_tpu/utils/plotting.py`:
`plot_mel`, `plot_multi_attn`, `plot_embedding`).  matplotlib (and sklearn for
the t-SNE of `plot_embedding`) are imported inside the
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


def plot_embedding(out_dir, embedding, embedding_speaker_id, gender_dict,
                   filename="embedding.png"):
    """t-SNE speaker-embedding plot colored by gender
    (`utils/tools.py:305-331`), saved under `out_dir`."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    from sklearn.manifold import TSNE

    colors = "r", "b"
    labels = "Female", "Male"
    embedding = np.asarray(embedding)
    data_x = embedding
    data_y = np.array([
        gender_dict.get(spk_id, "M") == "M"
        for spk_id in embedding_speaker_id], dtype=int)
    tsne_model = TSNE(n_components=2, random_state=0, init="random",
                      perplexity=min(30.0, max(1.0, len(data_x) - 1)))
    tsne_all_data = tsne_model.fit_transform(data_x)

    plt.figure(figsize=(10, 10))
    for i, (c, label) in enumerate(zip(colors, labels)):
        plt.scatter(tsne_all_data[data_y == i, 0],
                    tsne_all_data[data_y == i, 1],
                    c=c, label=label, alpha=0.5)
    plt.grid(True)
    plt.legend(loc="upper left")
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, filename))
    plt.close()
