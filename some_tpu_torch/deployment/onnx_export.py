"""ONNX export bridge: the port's weights -> .onnx for the DiffSinger ecosystem.

Counterpart of ``some_tpu/deployment/onnx_export.py``. The reference ships
its models to downstream MIDI editors as ONNX graphs (reference:
export.py:52-106, deployment/base_onnx_module.py,
deployment/me_onnx_module.py:9-39, deployment/me_quant_onnx_module.py:9-34):
waveform [1, n_samples] f32 in; note_midi / note_rest / note_dur
[1, n_notes] out, opset 17. ``deployment/export.py`` is the port's own
serving artifact (a ``torch.export`` program per bucket that runs the
hand-written kernels); this bridge exists for ecosystem parity, so a model
trained by the port becomes a drop-in .onnx for tools that consume the
reference's exports.

Route: the port's ``state_dict`` -> ``compat/to_torch.py`` -> the
first-party torch model of ``compat/torch_model.py`` (reference key layout)
-> torch mel + decode graph -> ``torch.onnx.export`` (TorchScript exporter).
The graph names no device and holds no hand-written kernel: it is traced on
the CPU, always, and the depthwise conv and the attention export as ONNX's
own ``Conv`` and ``MatMul``/``Softmax``. The ``onnx`` python package is
optional: torch's exporter serializes the proto itself and only imports
``onnx`` to merge onnxscript custom-op functions, of which this graph has
none; when ``onnx`` is absent that hook is replaced with its documented
no-custom-ops passthrough, on the torch versions it was verified on
(``_PATCH_KNOWN_TORCH``). The reference additionally runs onnxsim; graph
simplification is cosmetic and is skipped when onnxsim is unavailable.
"""
from __future__ import annotations

import pathlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from some_tpu_torch.audio.mel import hann_window, mel_filterbank

# task_cls -> ONNX module class name in this file
# (reference: deployment/__init__.py:5-8)
TASK_ONNX_MAPPING = {
    "training.MIDIExtractionTask": "MIDIExtractionONNXModule",
    "training.QuantizedMIDIExtractionTask": "QuantizedMIDIExtractionONNXModule",
}


class MelSpectrogramONNX(nn.Module):
    """ONNX-safe log-mel: torch.stft (opset-17 STFT) + mel matmul.

    Same constants as the port's frontends (``audio/mel.py``,
    ``ops/melspec.py``): periodic hann, HTK mel filterbank, log(clamp)
    (reference: deployment/base_onnx_module.py:37-81).
    """

    def __init__(self, n_mels: int, sample_rate: int, win_length: int,
                 hop_length: int, n_fft: Optional[int] = None,
                 fmin: float = 0, fmax: Optional[float] = None,
                 clamp: float = 1e-5):
        super().__init__()
        self.n_fft = win_length if n_fft is None else n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.clamp = clamp
        self.register_buffer("window", torch.from_numpy(
            hann_window(win_length, dtype=np.float64).astype(np.float32)))
        self.register_buffer("mel_basis", torch.from_numpy(
            mel_filterbank(sample_rate, self.n_fft, n_mels, fmin, fmax)
            .astype(np.float32)))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, n_samples] -> [B, n_mels, F].

        Explicit zero center-pad + center=False, matching the reference's
        TRAINING mel (reference: modules/rmvpe/spec.py:46-60) and this
        repo's engines exactly. The reference's own ONNX module instead
        uses torch.stft(center=True) whose reflect padding differs from
        what its model saw in training near chunk edges
        (reference: deployment/base_onnx_module.py:66-74) — kept the
        consistent semantics rather than the reference's drift.
        """
        audio = F.pad(audio, (self.win_length // 2, (self.win_length + 1) // 2))
        fft = torch.stft(audio, n_fft=self.n_fft, hop_length=self.hop_length,
                         win_length=self.win_length, window=self.window,
                         center=False, return_complex=False)
        magnitude = torch.sqrt(torch.sum(fft ** 2, dim=-1))
        mel = torch.matmul(self.mel_basis, magnitude)
        return torch.log(torch.clamp(mel, min=self.clamp))


def decode_gaussian_blurred_probs(probs: torch.Tensor, vmin: float,
                                  vmax: float, deviation: float,
                                  threshold: float):
    """The ONNX-traceable twin of ``ops/decode.decode_gaussian_blurred_probs``
    (reference: utils/infer_utils.py:9-24)."""
    num_bins = int(probs.shape[-1])
    interval = (vmax - vmin) / (num_bins - 1)
    width = int(3 * deviation / interval)
    idx = torch.arange(num_bins, device=probs.device)[None, None, :]
    idx_values = idx * interval + vmin
    center = torch.argmax(probs, dim=-1, keepdim=True)
    start = torch.clip(center - width, min=0)
    end = torch.clip(center + width + 1, max=num_bins)
    window_mask = (idx >= start) & (idx < end)
    weights = probs * window_mask
    product_sum = torch.sum(weights * idx_values, dim=2)
    weight_sum = torch.sum(weights, dim=2)
    values = product_sum / (weight_sum + (weight_sum == 0))
    rest = probs.max(dim=-1).values < threshold
    return values, rest


def decode_bounds_to_alignment(bounds: torch.Tensor,
                               use_diff: bool = True) -> torch.Tensor:
    """The ONNX-traceable twin of ``ops/decode.decode_bounds_to_alignment``
    (reference: utils/infer_utils.py:27-39)."""
    bounds_step = bounds.cumsum(dim=1).round().long()
    if use_diff:
        prev = F.pad(bounds_step[:, :-1], [1, 0], value=-1)
        bounds_inc = (bounds_step - prev) > 0
    else:
        bounds_inc = F.pad(bounds_step[:, 1:] > bounds_step[:, :-1],
                           [1, 0], value=True)
    return bounds_inc.long().cumsum(dim=1)


def decode_note_sequence(frame2item: torch.Tensor, values: torch.Tensor,
                         masks: torch.Tensor, threshold: float = 0.5):
    """The ONNX-traceable twin of ``ops/decode.decode_note_sequence``, with
    the data-dependent note count the reference graph carries (the engine's
    version pads to the static bound T+1 instead) (reference:
    utils/infer_utils.py:42-76)."""
    frame2item = frame2item.long()  # scatter indices must be int64
    b = frame2item.shape[0]
    num_seg = frame2item.max() + 1
    ones = torch.ones_like(frame2item)
    masks_i = masks.long()

    def seg_sum(src):
        return src.new_zeros(b, num_seg).scatter_add(1, frame2item, src)[:, 1:]

    item_dur = seg_sum(ones)
    item_unmasked = seg_sum(masks_i)
    item_masks = item_unmasked / item_dur >= threshold

    values_quant = values.round().long().clip(min=0, max=127)
    hist_ids = frame2item * 128 + values_quant
    histogram = frame2item.new_zeros(b, num_seg * 128).scatter_add(
        1, hist_ids, ones * masks_i).unflatten(1, [num_seg, 128])[:, 1:, :]
    item_center = histogram.float().argmax(dim=2).to(values.dtype)
    values_center = torch.gather(F.pad(item_center, [1, 0]), 1, frame2item)
    near_center = (masks & (values >= values_center - 0.5)
                   & (values <= values_center + 0.5))

    item_valid_dur = seg_sum(near_center.long())
    item_values = seg_sum(values * near_center) / \
        (item_valid_dur + (item_valid_dur == 0))
    return item_values, item_dur, item_masks


class _BaseONNXModule(nn.Module):
    """waveform -> notes graph around the first-party torch backbone."""

    def __init__(self, config: dict, state_dict: Dict[str, torch.Tensor]):
        super().__init__()
        from some_tpu_torch.compat.torch_model import load_from_state_dict

        self.config = config
        self.timestep = config["hop_size"] / config["audio_sample_rate"]
        self.model = load_from_state_dict(config, state_dict)
        self.mel_extractor = MelSpectrogramONNX(
            n_mels=config["units_dim"], sample_rate=config["audio_sample_rate"],
            win_length=config["win_size"], hop_length=config["hop_size"],
            fmin=config["fmin"], fmax=config["fmax"])


class MIDIExtractionONNXModule(_BaseONNXModule):
    """Continuous task: gaussian soft-argmax decode
    (reference: deployment/me_onnx_module.py:9-39)."""

    def __init__(self, config: dict, state_dict: Dict[str, torch.Tensor]):
        super().__init__(config, state_dict)
        self.midi_min = config["midi_min"]
        self.midi_max = config["midi_max"]
        self.midi_deviation = config["midi_prob_deviation"]
        self.rest_threshold = config["rest_threshold"]

    def forward(self, waveform: torch.Tensor):
        units = self.mel_extractor(waveform).transpose(1, 2)
        masks = torch.ones(units.shape[:2], dtype=torch.bool,
                           device=units.device)
        probs, bounds = self.model(x=units, mask=masks, sig=True)
        probs = probs * masks[..., None]
        bounds = bounds * masks
        frame2note = decode_bounds_to_alignment(bounds, use_diff=False) * masks
        midi, rest = decode_gaussian_blurred_probs(
            probs, vmin=self.midi_min, vmax=self.midi_max,
            deviation=self.midi_deviation, threshold=self.rest_threshold)
        note_midi, note_dur, note_mask = decode_note_sequence(
            frame2note, midi, ~rest & masks)
        return note_midi, ~note_mask, note_dur * self.timestep


class QuantizedMIDIExtractionONNXModule(_BaseONNXModule):
    """Quantized task: argmax decode, rest class 128
    (reference: deployment/me_quant_onnx_module.py:9-34)."""

    def forward(self, waveform: torch.Tensor):
        units = self.mel_extractor(waveform).transpose(1, 2)
        masks = torch.ones(units.shape[:2], dtype=torch.bool,
                           device=units.device)
        probs, bounds = self.model(x=units, mask=masks, sig=True)
        probs = probs * masks[..., None]
        bounds = bounds * masks
        frame2note = decode_bounds_to_alignment(bounds) * masks
        midi = probs.argmax(dim=-1)
        rest = midi == 128
        note_midi, note_dur, note_mask = decode_note_sequence(
            frame2note, midi.clip(min=0, max=127).float(), ~rest & masks)
        return note_midi, ~note_mask, note_dur * self.timestep


def build_onnx_module(config: dict, state_dict: Dict[str, torch.Tensor]) -> _BaseONNXModule:
    """The task's waveform -> notes module on the port's weights, on the CPU,
    in eval mode."""
    cls_name = TASK_ONNX_MAPPING.get(config["task_cls"])
    if cls_name is None:
        raise KeyError(f"no ONNX module registered for task "
                       f"{config['task_cls']!r}")
    return globals()[cls_name](config, state_dict).eval()


# torch major.minor versions whose TorchScript exporter internals the
# monkeypatch below was written against and verified on (each one by the ONNX
# check of chip_smoke.py or tests/test_torch_onnx.py on that version): a
# private-API patch must not silently outlive the API it patches.
_PATCH_KNOWN_TORCH = ("2.11", "2.13")


def _patch_missing_onnx_package() -> bool:
    """Allow torch.onnx.export without the ``onnx`` python package.

    The TorchScript exporter serializes the ModelProto itself; its only hard
    ``import onnx`` is ``_add_onnxscript_fn``, which merges onnxscript
    custom-op FunctionProtos into the graph and returns the bytes unchanged
    when there are none (torch/onnx/_internal/torchscript_exporter/
    onnx_proto_utils.py). This graph registers no onnxscript ops, so the
    passthrough is exact. Returns True if the patch was applied.

    The patch replaces a PRIVATE torch function, so it is gated on the torch
    versions it was verified against and fails loudly otherwise instead of
    silently producing a broken exporter on the next torch upgrade.
    """
    try:
        import onnx  # noqa: F401
        return False
    except ImportError:
        pass
    torch_mm = ".".join(torch.__version__.split(".")[:2])
    if torch_mm not in _PATCH_KNOWN_TORCH:
        raise RuntimeError(
            f"ONNX export without the 'onnx' package relies on patching a "
            f"private torch internal that is only verified on torch "
            f"{_PATCH_KNOWN_TORCH} (found {torch.__version__}). Either "
            f"`pip install onnx` (preferred), or re-verify the patch in "
            f"some_tpu_torch/deployment/onnx_export.py against this torch and add "
            f"'{torch_mm}' to _PATCH_KNOWN_TORCH.")
    try:
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
        if not callable(getattr(onnx_proto_utils, "_add_onnxscript_fn", None)):
            raise AttributeError("_add_onnxscript_fn missing")
    except (ImportError, AttributeError) as exc:
        raise RuntimeError(
            f"torch {torch.__version__} no longer exposes the internal the "
            f"onnx-less export path patches ({exc}); install the 'onnx' "
            f"package to export.") from exc

    onnx_proto_utils._add_onnxscript_fn = \
        lambda model_bytes, custom_opsets: model_bytes
    return True


def export_onnx(config: dict, state_dict: Dict[str, torch.Tensor],
                out_path: pathlib.Path | str) -> pathlib.Path:
    """Export the full waveform->notes graph as opset-17 ONNX, traced on the
    CPU (reference: export.py:66-106)."""
    out_path = pathlib.Path(out_path)
    module = build_onnx_module(config, state_dict)
    _patch_missing_onnx_package()
    waveform = torch.randn((1, 114514), dtype=torch.float32)
    with torch.no_grad():
        torch.onnx.export(
            module, waveform, str(out_path),
            input_names=["waveform"],
            output_names=["note_midi", "note_rest", "note_dur"],
            dynamic_axes={
                "waveform": {1: "n_samples"},
                "note_midi": {1: "n_notes"},
                "note_rest": {1: "n_notes"},
                "note_dur": {1: "n_notes"},
            },
            opset_version=17,
            dynamo=False,
        )
    _simplify_in_place(out_path)
    return out_path


def _simplify_in_place(out_path: pathlib.Path) -> None:
    """Run onnxsim + output-dim relabeling when the onnx toolchain exists
    (reference: export.py:96-106); a plain exporter graph otherwise."""
    try:
        import onnx
        import onnxsim
    except ImportError:
        return
    model = onnx.load(str(out_path))
    for value_info in model.graph.output:
        dims = value_info.type.tensor_type.shape.dim
        if len(dims) == 2:
            dims[1].dim_value = 0
            dims[1].dim_param = "n_notes"
    model, check = onnxsim.simplify(model, include_subgraph=True)
    if check:
        onnx.save(model, str(out_path))
