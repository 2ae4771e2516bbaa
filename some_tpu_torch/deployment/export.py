"""Deployment export: the waveform -> notes pipeline as one ``torch.export`` program per bucket.

Counterpart of ``some_tpu/deployment/export.py``, whose artifact is
serialized StableHLO. Here each frame bucket's program is the inference
engine's whole device pipeline (``_device_pipeline``: log-mel, conformer,
framewise decode, note aggregation), traced by ``torch.export.export`` with
the weights embedded and written by ``torch.export.save`` as
``bucket_<N>.pt2``, beside a ``manifest.json`` with the JAX manifest's keys.
As there, shapes are static: one program per bucket of the engine's grid,
``[1, bucket * hop - 1]`` float32 audio and a ``[1, bucket]`` bool mask in,
fixed-shape note arrays and ``n_notes`` out, and :func:`load_exported`
routes a waveform to its bucket and slices the notes on the host.

The JAX exporter traces under ``portable_mode`` because a Pallas kernel
cannot lower for the CPU half of its two-platform artifact. Here the kernels
are ``torch.library`` ops (``ops/library.py``) with a CUDA and a CPU
implementation, and ``torch.export`` records them by name: a program traced
on the card runs the hand-written kernels there, counted like the engine's
launches, and one traced on the CPU (``device="cpu"``) runs their plain
versions. A program holds its device in its constants, so it runs on the
device it was traced on and :func:`load_exported` refuses another. Loading
a ``.pt2`` needs ``some_tpu_torch`` importable, since it registers the ops.

An int8 engine (``quantize: int8``) exports as it serves: its weights
quantized at load, its products ``torch._int_mm``.

The artifact's input contract is native-rate float32 audio: the exporter
pins ``transfer_dtype: float32`` and ``wire_sr: None`` whatever the config
serves with (the half-rate wire's FIR runs on the host and cannot ride in the
program).
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from some_tpu_torch.inference.base_infer import resolve_device

FORMAT = "some-tpu-torch-export-v1"
DEFAULT_BUCKETS = (256, 512, 1024, 2048, 4096)


class _Pipeline(nn.Module):
    """The engine's device pipeline as a module, its model a submodule (so
    ``torch.export`` lifts the weights into the program)."""

    def __init__(self, engine):
        super().__init__()
        self.model = engine.model
        self.engine = engine

    def forward(self, audio: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.engine._device_pipeline(audio, mask)


class DeploymentExporter:
    """Traces an inference engine's device pipeline, one program per bucket."""

    infer_cls = None  # set by subclasses

    def __init__(self, config: dict, model_path=None, device=None,
                 state_dict: Dict[str, torch.Tensor] | None = None):
        config = dict(config, transfer_dtype="float32", wire_sr=None)
        self.engine = self.infer_cls(config=config, model_path=model_path, device=device,
                                     state_dict=state_dict)
        self.config = config

    def export(self, out_dir: pathlib.Path | str,
               buckets: Sequence[int] = DEFAULT_BUCKETS) -> pathlib.Path:
        """Trace and save each bucket's program, then the manifest."""
        from some_tpu_torch.ops import library

        library.register_fakes()
        engine = self.engine
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        pipeline = _Pipeline(engine).eval()
        hop, device = engine.hop, engine.device
        manifest: Dict[str, dict] = {}
        for bucket in buckets:
            if bucket not in engine.frame_buckets:
                raise ValueError(f"{bucket} is not a frame bucket (have {engine.frame_buckets})")
            n_samples = bucket * hop - 1
            audio = torch.zeros((1, n_samples), dtype=torch.float32, device=device)
            mask = torch.zeros((1, bucket), dtype=torch.bool, device=device)
            with torch.no_grad():
                program = torch.export.export(pipeline, (audio, mask))
            name = f"bucket_{bucket}.pt2"
            torch.export.save(program, out_dir / name)
            manifest[str(bucket)] = {"file": name, "n_samples": n_samples, "frames": bucket}
        (out_dir / "manifest.json").write_text(json.dumps({
            "format": FORMAT,
            "task_cls": self.config.get("task_cls"),
            "sample_rate": self.config["audio_sample_rate"],
            "hop_size": hop,
            "timestep": engine.timestep,
            "buckets": manifest,
            "device": device.type,
            "dtype": str(engine.dtype).replace("torch.", ""),
            "torch": torch.__version__,
        }, indent=2))
        return out_dir


class MIDIExtractionExporter(DeploymentExporter):
    @property
    def infer_cls(self):
        from some_tpu_torch.inference.me_infer import MIDIExtractionInference
        return MIDIExtractionInference


class QuantizedMIDIExtractionExporter(DeploymentExporter):
    @property
    def infer_cls(self):
        from some_tpu_torch.inference.me_quant_infer import QuantizedMIDIExtractionInference
        return QuantizedMIDIExtractionInference


# task_cls -> exporter (some_tpu/registry.py TASK_DEPLOYMENT_MAPPING)
TASK_DEPLOYMENT_MAPPING = {
    "training.MIDIExtractionTask": MIDIExtractionExporter,
    "training.QuantizedMIDIExtractionTask": QuantizedMIDIExtractionExporter,
    "some_tpu.training.me_task.MIDIExtractionTask": MIDIExtractionExporter,
    "some_tpu.training.me_quant_task.QuantizedMIDIExtractionTask":
        QuantizedMIDIExtractionExporter,
}


class _ExportedPipeline:
    """The loaded programs, by bucket, on the device they were traced on."""

    def __init__(self, out_dir: pathlib.Path, manifest: dict, device: torch.device):
        self.manifest = manifest
        self.device = device
        self.timestep = manifest["timestep"]
        self.programs = {int(bucket): torch.export.load(out_dir / meta["file"]).module()
                         for bucket, meta in manifest["buckets"].items()}

    @torch.inference_mode()
    def run_bucket(self, audio, mask) -> Dict[str, torch.Tensor]:
        """A bucket's program on ``[1, bucket * hop - 1]`` float32 audio and
        its ``[1, bucket]`` mask (numpy or tensors): its device outputs."""
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool).to(self.device)
        return self.programs[mask.shape[1]](audio, mask)

    def __call__(self, waveform: np.ndarray) -> Dict[str, np.ndarray]:
        """[n_samples] float32 -> sliced note dict."""
        hop = self.manifest["hop_size"]
        n_frames = len(waveform) // hop + 1
        bucket = min((b for b in sorted(self.programs) if b >= n_frames), default=None)
        if bucket is None:
            raise ValueError(f"waveform needs {n_frames} frames; largest exported bucket "
                             f"is {max(self.programs)}")
        n_samples = bucket * hop - 1
        audio = np.zeros((1, n_samples), np.float32)
        audio[0, :len(waveform)] = waveform[:n_samples]
        mask = np.zeros((1, bucket), bool)
        mask[0, :n_frames] = True
        out = {k: v.cpu().numpy() for k, v in self.run_bucket(audio, mask).items()}
        n = int(out["n_notes"][0])
        return {
            "note_midi": out["note_midi"][0, :n],
            "note_dur": out["note_dur"][0, :n].astype(np.float64) * self.timestep,
            "note_rest": out["note_rest"][0, :n],
        }


def load_exported(out_dir: pathlib.Path | str, device=None) -> _ExportedPipeline:
    """The artifact of :meth:`DeploymentExporter.export` as a callable
    (waveform in, sliced notes out). ``device`` defaults to ``cuda`` (raises
    without a card); it must be the device the programs were traced on."""
    from some_tpu_torch.ops import library

    library.register_fakes()  # registers the ops the programs call, with their fakes
    out_dir = pathlib.Path(out_dir)
    manifest = json.loads((out_dir / "manifest.json").read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{out_dir}: format {manifest.get('format')!r}, want {FORMAT!r}")
    device = resolve_device(device)
    if device.type != manifest["device"]:
        raise ValueError(f"{out_dir} holds programs traced on {manifest['device']}, which run "
                         f"there only, not on {device}; export again on {device.type}")
    return _ExportedPipeline(out_dir, manifest, device)
