"""Validation plots of both tasks, against the JAX tasks' figures.

It mirrors tests/test_training.py::test_validation_plots_are_produced for
the continuous and the quantized task (TINY_CONFIG: 1 layer, dim 32, f32):
a validation of ``Trainer.fit`` logs the JAX task's figure tags (``prob``,
``boundary``, ``midi``, ``final``; the quantized task has no ``prob``).
The figures' data are held against the JAX task's ``validation_plots`` on
the same batch and the same weights: every plotted line and the heatmap
within 1e-4 (f32 forwards of the two packages), the note rectangles at
the same starts and durations, their pitches within 1e-4.
With ``num_valid_plots: 0`` no figure is drawn and no device output read
for one, and without matplotlib the trainer logs once that plots are off
and trains on; a figure that raises (any exception) is logged with its
traceback and training goes on.
"""
import sys

import jax
import numpy as np
import pytest

from some_tpu.parallel.mesh import make_mesh, shard_batch
from some_tpu.training.me_quant_task import QuantizedMIDIExtractionTask as JaxQuantTask
from some_tpu.training.me_task import MIDIExtractionTask as JaxTask
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.data.indexed_dataset import IndexedDatasetWriter, save_lengths
from some_tpu_torch.training.me_quant_task import QuantizedMIDIExtractionTask
from some_tpu_torch.training.me_task import MIDIExtractionTask
from some_tpu_torch.training.trainer import Trainer
from tests.test_training import TINY_CONFIG, make_item

QUANT = dict(TINY_CONFIG, midi_num_bins=129, task_cls="training.QuantizedMIDIExtractionTask")
TASKS = {"continuous": (dict(TINY_CONFIG), MIDIExtractionTask, JaxTask, False,
                        {"prob", "boundary", "midi", "final"}),
         "quantized": (QUANT, QuantizedMIDIExtractionTask, JaxQuantTask, True,
                       {"boundary", "midi", "final"})}


class Writer:
    def __init__(self):
        self.scalars, self.figures = [], {}

    def add_scalar(self, tag, value, step):
        self.scalars.append(tag)

    def add_figure(self, tag, figure, step):
        assert figure is not None
        self.figures[tag] = figure


def _dataset(path, quant):
    rng = np.random.default_rng(114514)
    for prefix, n_items in (("train", 6), ("valid", 2)):
        lengths = []
        with IndexedDatasetWriter(path, prefix) as writer:
            for _ in range(n_items):
                item = make_item(rng, int(rng.integers(40, 120)), int(rng.integers(3, 8)),
                                 quant=quant)
                writer.add_item(item)
                lengths.append(item["length"])
        save_lengths(path, prefix, lengths)
    return path


@pytest.mark.parametrize("kind", sorted(TASKS))
def test_fit_logs_the_figures(kind, tmp_path):
    config, cls, _, quant, tags = TASKS[kind]
    config = dict(config, num_valid_plots=1, val_check_interval=2, ds_workers=0,
                  binary_data_dir=str(_dataset(tmp_path / "binary", quant)))
    writer = Writer()
    Trainer(cls(config, device="cpu"), tmp_path / "w", log_writer=writer).fit(max_steps=2)
    assert {t.split("/")[0] for t in writer.figures} == tags, sorted(writer.figures)
    assert any(t.startswith("validation/") for t in writer.scalars)


def _lines(fig):
    return [np.asarray(line.get_ydata(), np.float64) for ax in fig.axes for line in ax.lines]


def _rects(fig):
    """Each note rectangle as [x, y, width, height]."""
    import matplotlib.patches as mpatches

    return np.array([(*p.get_xy(), p.get_width(), p.get_height()) for ax in fig.axes
                     for p in ax.patches if isinstance(p, mpatches.Rectangle)], np.float64)


@pytest.mark.parametrize("kind", sorted(TASKS))
def test_figures_match_jax(kind):
    config, cls, jcls, quant, tags = TASKS[kind]
    config = dict(config, frame_bucket_grid=32)
    jtask = jcls(dict(config))
    jstate = jtask.init_state()
    task = cls(dict(config), device="cpu")
    state = task.init_state()
    state.model.load_state_dict(jax_params_to_state_dict(jax.device_get(jstate.params),
                                                         jax.device_get(jstate.batch_stats)))
    rng = np.random.default_rng(3)
    batch = task.collate([make_item(rng, 70, 6, quant=quant), make_item(rng, 52, 4, quant=quant)])
    valid_step = jtask.make_valid_step(make_mesh(jax.devices()[:1]))
    _, jextras = valid_step(jstate, shard_batch(batch, make_mesh(jax.devices()[:1])))
    _, extras = task.valid_step(state, batch)

    class Host:
        def __init__(self):
            self.log_writer = Writer()

    want, got = Host(), Host()
    jtask.validation_plots(want, 0, batch, jextras, 5)
    task.validation_plots(got, 0, batch, extras, 5)
    assert set(got.log_writer.figures) == set(want.log_writer.figures) == {f"{t}/0" for t in tags}
    for tag, fig in want.log_writer.figures.items():
        ours = got.log_writer.figures[tag]
        lines_w, lines_o = _lines(fig), _lines(ours)
        assert len(lines_w) == len(lines_o) > 0 or tag.startswith("prob"), tag
        for a, b in zip(lines_o, lines_w):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=tag)
        rects_o, rects_w = _rects(ours), _rects(fig)
        assert rects_o.shape == rects_w.shape, tag
        if rects_w.size:  # starts and durations exact, pitches to f32 rounding
            np.testing.assert_array_equal(rects_o[:, [0, 2, 3]], rects_w[:, [0, 2, 3]])
            np.testing.assert_allclose(rects_o[:, 1], rects_w[:, 1], atol=1e-4, rtol=0)
        if tag.startswith("prob"):
            heat_o, heat_w = (np.asarray(f.axes[0].collections[0].get_array()) for f in (ours, fig))
            np.testing.assert_allclose(heat_o, heat_w, atol=1e-4, rtol=0)
    import matplotlib.pyplot as plt

    plt.close("all")


def test_no_figure_without_num_valid_plots(tmp_path, monkeypatch):
    config = dict(TINY_CONFIG, num_valid_plots=0, val_check_interval=2, ds_workers=0,
                  binary_data_dir=str(_dataset(tmp_path / "binary", False)))
    task = MIDIExtractionTask(config, device="cpu")
    called = []
    monkeypatch.setattr(task, "validation_plots", lambda *a: called.append(a))
    writer = Writer()
    Trainer(task, tmp_path / "w", log_writer=writer).fit(max_steps=2)
    assert not called and not writer.figures
    assert any(t.startswith("validation/") for t in writer.scalars)


def test_plots_off_without_matplotlib(tmp_path, monkeypatch, caplog):
    config = dict(TINY_CONFIG, num_valid_plots=2, val_check_interval=1, ds_workers=0,
                  binary_data_dir=str(_dataset(tmp_path / "binary", False)))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    task = MIDIExtractionTask(config, device="cpu")
    called = []
    monkeypatch.setattr(task, "validation_plots", lambda *a: called.append(a))
    writer = Writer()
    with caplog.at_level("INFO", logger="some_tpu_torch.trainer"):
        state = Trainer(task, tmp_path / "w", log_writer=writer).fit(max_steps=2)
    assert state.step == 2 and not called and not writer.figures
    assert caplog.text.count("validation plots are off: matplotlib does not import") == 1


@pytest.mark.parametrize("error", [KeyError("prob"), AttributeError("no such field"),
                                   NotImplementedError("figure")])
def test_a_failed_figure_is_logged_and_training_goes_on(tmp_path, monkeypatch, caplog, error):
    config = dict(TINY_CONFIG, num_valid_plots=2, val_check_interval=1, ds_workers=0,
                  binary_data_dir=str(_dataset(tmp_path / "binary", False)))
    task = MIDIExtractionTask(config, device="cpu")

    def validation_plots(*args):
        raise error

    monkeypatch.setattr(task, "validation_plots", validation_plots)
    with caplog.at_level("WARNING", logger="some_tpu_torch.trainer"):
        state = Trainer(task, tmp_path / "w", log_writer=Writer()).fit(max_steps=2)
    assert state.step == 2
    failed = [r for r in caplog.records if "validation plot of batch" in r.getMessage()]
    assert failed and all(r.exc_info[1] is error for r in failed), caplog.text
