"""Validation and diagnostic figures.

Counterpart of ``some_tpu/utils/plot.py``: probability heatmaps, boundary
cumsum curves with duration lines, piano-roll rectangles over the pitch
curve, plain curves, and the binarizer's MIDI histogram. matplotlib is
imported inside each function, so the port imports without it (the GPU
machine has none); the trainer turns its validation plots off there.
"""
from __future__ import annotations

import math

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MultipleLocator

    return plt, MultipleLocator


def spec_to_figure(spec: np.ndarray, vmin=None, vmax=None):
    plt, _ = _pyplot()
    spec = np.asarray(spec)
    fig = plt.figure(figsize=(12, 15))
    plt.pcolor(spec.T, vmin=vmin, vmax=vmax)
    plt.tight_layout()
    return fig


def dur_to_figure(dur_gt, dur_pred, txt):
    """Token-duration alignment: two rails of cumulative-duration lines (gt
    below, pred above), each token's label over its span, dotted lines
    joining paired boundaries."""
    plt, _ = _pyplot()
    ends_gt = np.cumsum(np.asarray(dur_gt).astype(np.int64))
    ends_pred = np.cumsum(np.asarray(dur_pred).astype(np.int64))
    width = max(12, min(48, len(txt) // 2))
    fig = plt.figure(figsize=(width, 8))
    plt.vlines(ends_pred, 12, 22, colors="r", label="pred")
    plt.vlines(ends_gt, 0, 10, colors="b", label="gt")

    def centers(ends):
        starts = np.concatenate([[0], ends[:-1]])
        return (starts + ends) / 2

    mid_pred, mid_gt = centers(ends_pred), centers(ends_gt)
    for i, token in enumerate(txt):
        stagger = (i % 8) + 1
        plt.text(mid_pred[i], 12 + stagger, token, size=16, horizontalalignment="center")
        plt.text(mid_gt[i], stagger, token, size=16, horizontalalignment="center")
        plt.plot([ends_pred[i], ends_gt[i]], [12, 10], color="black", linewidth=2,
                 linestyle=":")
    plt.yticks([])
    plt.xlim(0, max(ends_pred[-1], ends_gt[-1]))
    fig.legend()
    fig.tight_layout()
    return fig


def boundary_to_figure(bounds_gt: np.ndarray, bounds_pred: np.ndarray,
                       dur_gt: np.ndarray = None, dur_pred: np.ndarray = None):
    plt, MultipleLocator = _pyplot()
    fig = plt.figure(figsize=(12, 6))
    acc_gt = np.cumsum(bounds_gt)
    acc_pred = np.cumsum(bounds_pred)
    plt.plot(acc_gt, color="b", label="gt")
    plt.plot(acc_pred, color="r", label="pred")
    if dur_gt is not None and dur_pred is not None and len(dur_gt) and len(dur_pred):
        height = math.ceil(max(acc_gt[-1], acc_pred[-1]))
        plt.vlines(np.cumsum(dur_gt)[:-1], 0, height / 2, colors="b", linestyles="--")
        plt.vlines(np.cumsum(dur_pred)[:-1], height / 2, height, colors="r", linestyles="--")
    plt.gca().yaxis.set_major_locator(MultipleLocator(1))
    plt.grid(axis="y")
    plt.legend()
    plt.tight_layout()
    return fig


def pitch_notes_to_figure(pitch: np.ndarray, note_midi_gt, note_dur_gt, note_rest_gt,
                          note_midi_pred=None, note_dur_pred=None, note_rest_pred=None):
    plt, MultipleLocator = _pyplot()
    fig = plt.figure()

    def draw(note_midi, note_dur, note_rest, color, label):
        if note_midi is None:
            return
        acc = np.cumsum(note_dur)
        if note_rest is None:
            note_rest = np.zeros_like(note_midi, dtype=bool)
        labeled = False
        for i in range(len(note_midi)):
            if note_rest[i]:
                continue
            x0 = acc[i - 1] if i > 0 else 0
            y0 = note_midi[i] - 0.5
            plt.gca().add_patch(plt.Rectangle(
                (x0, y0), note_dur[i], 1, edgecolor=color, fill=False, linewidth=1.5,
                label=label if not labeled else None))
            plt.fill_between([x0, x0 + note_dur[i]], y0, y0 + 1, color="none",
                             facecolor=color, alpha=0.2)
            labeled = True

    draw(note_midi_gt, note_dur_gt, note_rest_gt, "b", "gt")
    draw(note_midi_pred, note_dur_pred, note_rest_pred, "r", "pred")
    plt.plot(pitch, color="grey", label="pitch")
    plt.gca().yaxis.set_major_locator(MultipleLocator(1))
    plt.grid(axis="y")
    plt.legend()
    plt.tight_layout()
    return fig


def curve_to_figure(curve_gt, curve_pred=None, curve_base=None, grid=None,
                    base_label="base"):
    plt, MultipleLocator = _pyplot()
    fig = plt.figure()
    if curve_base is not None:
        plt.plot(curve_base, color="grey", label=base_label)
    plt.plot(curve_gt, color="b", label="gt")
    if curve_pred is not None:
        plt.plot(curve_pred, color="r", label="pred")
    if grid is not None:
        plt.gca().yaxis.set_major_locator(MultipleLocator(grid))
    plt.grid(axis="y")
    plt.legend()
    plt.tight_layout()
    return fig


def distribution_to_figure(title, x_label, y_label, items: list, values: list,
                           zoom=0.8):
    plt, _ = _pyplot()
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
