"""Bucketed static-shape inference engine.

Counterpart of ``some_tpu/inference/base_infer.py``. Chunks are padded up to
a geometric frame-bucket grid and batched within a bucket, with the batch
rows padded up to a row-bucket grid; the padding rows have all-False masks
and decode to no notes. The model's masks make a padded bucket reproduce the
unpadded sequence. Chunks longer than the largest bucket are split at the
bucket boundary and joined again by ``merge_parts``.

``infer`` dispatches every group first and fetches afterwards: PyTorch queues
CUDA work without waiting, so the host pads later groups while the card
computes earlier ones. Staging on CUDA streams and CUDA graphs per bucket are
later work.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit device it raises rather than fall back.
"""
from __future__ import annotations

import pathlib
import sys
from typing import Dict, List

import numpy as np
import torch

from some_tpu_torch.audio.wire import WIRES, encode_wire, silence_buffer
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.utils.checkpoint import load_state_dict

DEFAULT_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
                   6144, 8192, 12288, 16384, 24576, 32768)
DEFAULT_BATCH_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises when CUDA is absent
    and no device was asked for, so nothing falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: some_tpu_torch runs on the GPU; pass "
                               "device='cpu' (--device cpu) to run on the CPU")
        device = "cuda"
    return torch.device(device)


def pick_bucket(n_frames: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n_frames <= b:
            return b
    raise ValueError(f"chunk of {n_frames} frames exceeds the largest bucket "
                     f"{buckets[-1]}; slice the audio first")


def pick_batch_bucket(n_rows: int, cap: int, buckets=DEFAULT_BATCH_BUCKETS) -> int:
    for b in buckets:
        if b >= cap:
            return cap
        if n_rows <= b:
            return b
    b = buckets[-1]
    while b < n_rows:
        b = min(cap, b * 3 // 2)
    return b


class BaseInference:
    def __init__(self, config: dict, model_path: pathlib.Path | str | None,
                 dtype: torch.dtype | None = None, max_batch_chunks: int = 8,
                 device=None, state_dict: Dict[str, torch.Tensor] | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.model_path = model_path
        self.timestep = config["hop_size"] / config["audio_sample_rate"]
        self.wire = str(config.get("transfer_dtype", "int16"))
        if self.wire not in WIRES:
            raise NotImplementedError(
                f"transfer_dtype {self.wire!r} is still to port (have {WIRES}): see ROADMAP.md")
        wire_sr = config.get("wire_sr")
        if wire_sr and int(wire_sr) != int(config["audio_sample_rate"]):
            raise NotImplementedError("wire_sr (the half-rate wire) is still to port: "
                                      "see ROADMAP.md")
        self.hop = config["hop_size"]
        self.max_batch_chunks = max_batch_chunks
        if dtype is None:
            precision = str(config.get("pl_trainer_precision", "bf16"))
            dtype = torch.float32 if "32" in precision else torch.bfloat16
        self.dtype = dtype
        self.frame_buckets = DEFAULT_BUCKETS
        #: model forwards run; each runs every kernel of the model once per block
        self.forwards = 0
        with torch.device(self.device):
            self.model = self.build_model().eval()
        if state_dict is None:
            state_dict = load_state_dict(model_path)
        self.model.load_state_dict(state_dict, strict=True)

    @classmethod
    def from_state_dict(cls, config: dict, state_dict: Dict[str, torch.Tensor], **kwargs):
        """An engine from in-memory weights (no checkpoint file)."""
        return cls(config, model_path=None, state_dict=state_dict, **kwargs)

    def build_model(self):
        return build_midi_extractor(self.config, dtype=self.dtype)

    def stage_inputs(self, audio: np.ndarray, frame_mask: np.ndarray):
        return (torch.from_numpy(audio).to(self.device),
                torch.from_numpy(frame_mask).to(self.device))

    def run_bucket_staged(self, audio, frame_mask) -> dict:
        raise NotImplementedError

    def run_bucket(self, audio: np.ndarray, frame_mask: np.ndarray) -> dict:
        return self.run_bucket_staged(*self.stage_inputs(audio, frame_mask))

    def assemble(self, device_out: dict, n_frames: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _log_bucket_path(self, n_frames: int) -> None:
        """Say once per bucket which attention path it runs (stderr: stdout
        belongs to the surfaces' own output)."""
        if not hasattr(self, "_logged_buckets"):
            self._logged_buckets = set()
        if n_frames in self._logged_buckets:
            return
        self._logged_buckets.add(n_frames)
        impl = self.config.get("attention_impl", "auto")
        path = "plain" if impl == "xla" or self.device.type == "cpu" else "flash kernel"
        print(f"| bucket T={n_frames}: attention={path}", file=sys.stderr)

    def infer(self, waveforms: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Chunk list -> note dicts, batched per bucket: dispatch every group,
        then fetch and assemble."""
        buckets = self.frame_buckets
        max_samples = buckets[-1] * self.hop - 1
        jobs = []
        n_parts = [0] * len(waveforms)
        for i, w in enumerate(waveforms):
            for part, start in enumerate(range(0, max(len(w), 1), max_samples)):
                piece = w[start:start + max_samples]
                n_frames = len(piece) // self.hop + 1
                jobs.append({"idx": i, "part": part, "wave": piece, "frames": n_frames,
                             "bucket": pick_bucket(n_frames, buckets)})
                n_parts[i] = part + 1
        parts: List[list] = [[None] * n for n in n_parts]

        by_bucket: Dict[int, list] = {}
        for job in jobs:
            by_bucket.setdefault(job["bucket"], []).append(job)

        pending = []
        for bucket, bucket_jobs in sorted(by_bucket.items()):
            self._log_bucket_path(bucket)
            for start in range(0, len(bucket_jobs), self.max_batch_chunks):
                group = bucket_jobs[start:start + self.max_batch_chunks]
                # the largest sample count that still gives exactly `bucket` frames
                n_samples = bucket * self.hop - 1
                rows = pick_batch_bucket(len(group), self.max_batch_chunks)
                audio = silence_buffer(self.wire, rows, n_samples)
                mask = np.zeros((rows, bucket), dtype=bool)
                for row, job in enumerate(group):
                    wave = encode_wire(job["wave"][:n_samples], self.wire)
                    audio[row, :len(wave)] = wave
                    mask[row, :job["frames"]] = True
                pending.append((group, self.run_bucket(audio, mask)))

        for group, out in pending:
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for row, job in enumerate(group):
                parts[job["idx"]][job["part"]] = self.assemble(
                    {k: v[row] for k, v in out.items()}, job["frames"])
        return [p[0] if len(p) == 1 else self.merge_parts(p) for p in parts]

    def merge_parts(self, parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Reassemble one oversize chunk from its splits: plain concatenation;
        subclasses repair the seams."""
        return {k: np.concatenate([d[k] for d in parts]) for k in parts[0]}


# task_cls -> inference engine (some_tpu/registry.py TASK_INFERENCE_MAPPING)
TASK_INFERENCE_MAPPING = {
    "training.MIDIExtractionTask": "some_tpu_torch.inference.me_infer.MIDIExtractionInference",
    "some_tpu.training.me_task.MIDIExtractionTask":
        "some_tpu_torch.inference.me_infer.MIDIExtractionInference",
}


def build_inference(config: dict, model_path: pathlib.Path | str, **kwargs) -> BaseInference:
    """task_cls -> inference engine."""
    import importlib

    path = TASK_INFERENCE_MAPPING.get(config["task_cls"])
    if path is None:
        raise NotImplementedError(f"no inference engine ported for task "
                                  f"{config['task_cls']!r} (the quantized task is "
                                  "still to port: see ROADMAP.md)")
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)(config, model_path, **kwargs)
