"""The binarizer's MIDI histogram (``distribution_to_figure``, from
``some_tpu/utils/plot.py:128``). matplotlib is imported inside the
function, so the port imports without it; the figure is optional."""
from __future__ import annotations


def distribution_to_figure(title, x_label, y_label, items: list, values: list,
                           zoom=0.8):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(max(int(len(items) * zoom), 4), 10))
    plt.bar(x=items, height=values)
    plt.tick_params(labelsize=15)
    plt.xlim(-1, len(items))
    for a, b in zip(items, values):
        plt.text(a, b, b, ha="center", va="bottom", fontsize=15)
    plt.grid()
    plt.title(title, fontsize=30)
    plt.xlabel(x_label, fontsize=20)
    plt.ylabel(y_label, fontsize=20)
    return fig
