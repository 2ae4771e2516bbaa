"""Bucketed static-shape inference engine.

Counterpart of ``some_tpu/inference/base_infer.py``. Chunks are padded up to
a geometric frame-bucket grid and batched within a bucket, with the batch
rows padded up to a row-bucket grid; the padding rows have all-False masks
and decode to no notes. The model's masks make a padded bucket reproduce the
unpadded sequence. Chunks longer than the largest bucket are split at the
bucket boundary and joined again by ``merge_parts``.

Dispatch, as the JAX engine's:

* **One program per bucket.** On ``cuda`` the whole device pipeline of a
  (wire, rows, frames) bucket (wire decode, log-mel, model, note decode) is
  one ``torch.cuda.CUDAGraph``, replayed from static input tensors. A
  bucket's first run is eager; its second captures the graph (after one
  eager warm-up on the capture's side stream), so a bucket seen once, as
  most are in one file through the CLI, pays no capture; ``prewarm``
  captures at once. All of an engine's graphs share one memory pool, and
  each run hands back device copies of the note arrays before another
  replay can overwrite them. A capture that fails raises; nothing falls
  back to eager dispatch. The JAX engine's counterpart is its ``jax.jit``
  per bucket shape. On the CPU the same pipeline runs eagerly.
* **Staged transfers.** ``stage_inputs`` copies a group's host rows into
  pinned memory and starts their copy to the card on a staging stream;
  ``run_bucket_staged`` makes the compute stream wait for it. ``infer``
  stages group N+1 on one worker thread while group N computes, to a
  bounded lookahead (``SOME_TPU_STREAM_DEPTH``, default 1; 0 or
  ``SOME_TPU_STREAM_GROUPS=0`` is serial).
* **The wire** (``transfer_dtype``: int16, float32, mulaw8, mulaw12, or
  ``auto``, a policy re-probed on a TTL) and the half-rate wire
  (``wire_sr``): a wire flip rebuilds the mel frontend and drops every
  captured graph.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit device it raises rather than fall back.
"""
from __future__ import annotations

import os
import pathlib
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from some_tpu_torch.audio.wire import check_wire, encode_wire, silence_buffer
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.ops.quant import adopt_int8_layout, quantize_params
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


class _BucketGraph:
    """One captured pipeline: its static inputs, the graph, its static outputs."""

    def __init__(self, audio: torch.Tensor, mask: torch.Tensor, graph, out: dict):
        self.audio, self.mask, self.graph, self.out = audio, mask, graph, out


def set_dispatch(engine: "BaseInference", mode: str) -> None:
    """Test-only switch: 'graph' (the default) replays one CUDA graph per
    bucket on the card from a bucket's second run on, 'eager' launches the
    pipeline op by op there on every run (to hold the two against each
    other). The CPU always runs eagerly; no config key or CLI flag reads
    this."""
    if mode not in ("graph", "eager"):
        raise ValueError(f"unknown dispatch {mode!r} (graph | eager)")
    engine._graph_dispatch = mode == "graph"


class BaseInference:
    #: the run of a bucket that captures its graph: its first runs eagerly,
    #: since a capture (an eager warm-up, then the capture) costs about
    #: three eager runs and a bucket seen once never earns it back
    CAPTURE_ON_VISIT = 2
    #: the device pipeline's outputs that ``run_bucket_staged`` hands back
    OUTPUT_KEYS = ()
    #: and the frame-level ones it adds with ``frames=True``
    FRAME_KEYS = ()

    def __init__(self, config: dict, model_path: pathlib.Path | str | None,
                 dtype: torch.dtype | None = None, max_batch_chunks: int = 8,
                 device=None, state_dict: Dict[str, torch.Tensor] | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.model_path = model_path
        self.timestep = config["hop_size"] / config["audio_sample_rate"]
        self._graphs: Dict[tuple, _BucketGraph] = {}
        self._visits: Dict[tuple, int] = {}
        self._pool = None  # the graphs' one memory pool, made at the first capture
        self._graph_dispatch = True
        self._capture_lock = threading.Lock()
        # (staging, capture) streams of the card
        self._streams = ((torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
                         if self.device.type == "cuda" else None)
        # transfer_dtype: auto resolves before the wire factor: its slow-link
        # choice is the half-rate wire where the mel geometry allows it. It
        # is a live policy, re-probed on a TTL at infer() time; every
        # decision is kept in wire_decision.
        wire = str(config.get("transfer_dtype", "int16"))
        self._wire_auto = wire == "auto"
        self._wire_base_config = dict(config)
        self._wire_threshold_mb_s = float(
            os.environ.get("SOME_TPU_WIRE_THRESHOLD_MB_S")
            or config.get("wire_probe_threshold_mb_s") or 200.0)
        self._wire_probe_ttl_s = float(
            os.environ.get("SOME_TPU_WIRE_PROBE_TTL_S")
            or config.get("wire_probe_ttl_s") or 300.0)
        self.wire_decision = None
        self._auto_wire_sr = None
        if self._wire_auto:
            mb_s = self._probe_link_mb_s(self.device)
            self._wire_probe_time = time.monotonic()
            wire, self._auto_wire_sr = self._auto_wire_policy(
                mb_s, config, self._wire_threshold_mb_s)
            self._record_wire_decision(mb_s, wire)
        self._set_wire(wire, self._auto_wire_sr)
        self.max_batch_chunks = max_batch_chunks
        if dtype is None:
            precision = str(config.get("pl_trainer_precision", "bf16"))
            dtype = torch.float32 if "32" in precision else torch.bfloat16
        self.dtype = dtype
        self.frame_buckets = DEFAULT_BUCKETS
        #: forwards run: eager pipeline runs and graph replays (a capture's
        #: warm-up and the capture itself do not count)
        self.forwards = 0
        with torch.device(self.device):
            self.model = self.build_model().eval()
        if state_dict is None:
            state_dict = load_state_dict(model_path)
        self._load_weights(state_dict)

    def _load_weights(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Fill the model. With ``quantize: int8`` the weights are quantized
        once, here, unless they arrive int8 already (a quantized checkpoint,
        the JAX engine's variables carried across): the guard reads the
        weights' dtypes, as the JAX engine's does."""
        quantized = any(t.dtype == torch.int8 for t in state_dict.values())
        if self.model.quant != "int8":
            if quantized:
                raise ValueError("int8 weights need quantize: int8 in the config")
            self.model.load_state_dict(state_dict, strict=True)
            return
        if quantized:
            adopt_int8_layout(self.model, state_dict)
        self.model.load_state_dict(state_dict, strict=True)
        if not quantized:
            quantize_params(self.model)

    @property
    def weight_bytes(self) -> int:
        """Bytes of the model's weights resident on the engine's device
        (parameters and buffers: int8 weights and their scales once
        quantized; the f32 master weights otherwise, whatever the compute
        dtype, as in the JAX engine)."""
        return sum(t.numel() * t.element_size() for t in self.model.state_dict().values())

    @classmethod
    def from_state_dict(cls, config: dict, state_dict: Dict[str, torch.Tensor], **kwargs):
        """An engine from in-memory weights (no checkpoint file)."""
        return cls(config, model_path=None, state_dict=state_dict, **kwargs)

    def build_model(self):
        return build_midi_extractor(self.config, dtype=self.dtype)

    # ---- the wire ----

    @staticmethod
    def _resolve_wire_factor(config: dict) -> int:
        """Validate ``wire_sr`` against the mel geometry; return the integer
        decimation factor (1 = the wire at the native rate)."""
        sr = int(config["audio_sample_rate"])
        wire_sr = int(config.get("wire_sr") or 0)
        if not wire_sr or wire_sr == sr:
            return 1
        if sr % wire_sr:
            raise ValueError(f"wire_sr {wire_sr} must divide audio_sample_rate {sr} evenly")
        factor = sr // wire_sr
        hop, win = int(config["hop_size"]), int(config["win_size"])
        fft = int(config.get("fft_size") or win)
        if hop % factor or win % factor or fft % factor:
            raise ValueError(f"wire_sr {wire_sr}: hop/win/fft ({hop}/{win}/{fft}) must all "
                             f"be divisible by the decimation factor {factor}")
        fmax = float(config.get("fmax") or sr / 2)
        if fmax > wire_sr / 2:
            raise ValueError(f"wire_sr {wire_sr} cannot represent fmax {fmax} "
                             f"(needs wire_sr >= {2 * fmax:.0f})")
        return factor

    @staticmethod
    def _probe_link_mb_s(device: torch.device, probe_mb: float = 8.0) -> float:
        """One timed copy of ``probe_mb`` MB of pageable host memory to the
        engine's device, after one untimed copy to warm the path."""
        buf = torch.zeros(int(probe_mb * (1 << 20) // 2), dtype=torch.int16)

        def copy():
            buf.to(device, copy=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        copy()
        t0 = time.perf_counter()
        copy()
        return probe_mb / max(time.perf_counter() - t0, 1e-9)

    @classmethod
    def _auto_wire_policy(cls, mb_s: float, config: dict, threshold_mb_s: float = 200.0):
        """``transfer_dtype: auto``: (wire, wire_sr or None) for the measured
        link. A healthy link gets int16 at the native rate; a slow one the
        half-rate int16 wire where the mel geometry allows it, else mulaw12.
        The choice goes to stderr; set transfer_dtype / wire_sr to pin it."""
        wire, wire_sr = "int16", None
        if mb_s < threshold_mb_s and not config.get("wire_sr"):
            half = int(config["audio_sample_rate"]) // 2
            try:
                cls._resolve_wire_factor(dict(config, wire_sr=half))
                wire_sr = half
            except (ValueError, KeyError):
                wire = "mulaw12"
        print(f"| transfer_dtype auto: link ~{mb_s:.0f} MB/s -> {wire}"
              + (f" @ wire_sr {wire_sr}" if wire_sr else ""), file=sys.stderr)
        return wire, wire_sr

    def _set_wire(self, wire: str, auto_wire_sr=None) -> None:
        """Apply a wire choice to every wire-derived field. ``auto_wire_sr``
        overlays the base config's own wire_sr (None keeps a pinned value)."""
        check_wire(wire)
        config = dict(self._wire_base_config)
        if auto_wire_sr:
            config["wire_sr"] = auto_wire_sr
        self.config = config
        self.wire = wire
        self.wire_factor = self._resolve_wire_factor(config)
        self.wire_sr = config["audio_sample_rate"] // self.wire_factor
        self.hop = config["hop_size"] // self.wire_factor

    def _record_wire_decision(self, mb_s: float, wire: str) -> None:
        self.wire_decision = {"link_mb_s": round(mb_s, 1),
                              "threshold_mb_s": self._wire_threshold_mb_s, "wire": wire,
                              "wire_sr": self._auto_wire_sr, "ttl_s": self._wire_probe_ttl_s}

    def _rebuild_wire_pipeline(self) -> None:
        """Rebuild what derives from the wire: every captured graph baked
        the old wire's dtype, width and hop in, so they all go, with their
        pool and the visit counts. Subclasses rebuild their mel frontend
        too."""
        self._graphs.clear()
        self._visits.clear()
        self._pool = None

    def maybe_reprobe_wire(self) -> None:
        """TTL re-evaluation of ``transfer_dtype: auto``: one clock read
        while the TTL holds, else one timed 8 MB copy. On a flip the graphs
        go and the buckets start their runs' count again."""
        if not self._wire_auto:
            return
        if time.monotonic() - self._wire_probe_time < self._wire_probe_ttl_s:
            return
        mb_s = self._probe_link_mb_s(self.device)
        self._wire_probe_time = time.monotonic()
        wire, wire_sr = self._auto_wire_policy(mb_s, self._wire_base_config,
                                               self._wire_threshold_mb_s)
        previous = (self.wire, self._auto_wire_sr)
        self._auto_wire_sr = wire_sr
        self._record_wire_decision(mb_s, wire)
        if (wire, wire_sr) != previous:
            self._set_wire(wire, wire_sr)
            self._rebuild_wire_pipeline()

    # ---- dispatch ----

    def _device_pipeline(self, audio: torch.Tensor, mask: torch.Tensor) -> dict:
        """Wire rows [rows, wire_width] + mask [rows, frames] -> a dict of
        fixed-shape device arrays (OUTPUT_KEYS and FRAME_KEYS)."""
        raise NotImplementedError

    def stage_inputs(self, audio: np.ndarray, frame_mask: np.ndarray):
        """Host rows -> (audio, mask, ready) on the engine's device, no
        compute dispatched. On the card the rows go through pinned memory
        and a non-blocking copy on the staging stream; ``ready`` is the
        event recorded after it (None on the CPU). The pinned blocks come
        from PyTorch's caching host allocator, which reuses a block only
        once the copy's event has completed."""
        if self.device.type != "cuda":
            return (torch.from_numpy(audio).to(self.device),
                    torch.from_numpy(frame_mask).to(self.device), None)
        staging = self._streams[0]
        with torch.cuda.stream(staging):
            audio_dev = torch.from_numpy(audio).pin_memory().to(self.device, non_blocking=True)
            mask_dev = torch.from_numpy(frame_mask).pin_memory().to(self.device,
                                                                   non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(staging)
        return audio_dev, mask_dev, ready

    @torch.inference_mode()
    def run_bucket_staged(self, audio: torch.Tensor, mask: torch.Tensor, ready=None,
                          frames: bool = False, capture: bool = False) -> dict:
        """Run the pipeline on staged device inputs (``stage_inputs``, or
        tensors already on the device with ``ready`` None). On the card this
        replays the bucket's graph, capturing it on the bucket's
        ``CAPTURE_ON_VISIT``-th run (at once with ``capture``), and returns
        device copies of its outputs; ``frames=True`` adds the frame-level
        outputs (FRAME_KEYS)."""
        keys = self.OUTPUT_KEYS + (self.FRAME_KEYS if frames else ())
        if self.device.type == "cuda":
            compute = torch.cuda.current_stream(self.device)
            if ready is not None:
                compute.wait_event(ready)
            # the staged tensors were allocated on the staging stream
            audio.record_stream(compute)
            mask.record_stream(compute)
        entry = None
        if self.device.type == "cuda" and self._graph_dispatch:
            key = (self.wire, *mask.shape)
            entry = self._graphs.get(key)
            if entry is None:
                visit = self._visits[key] = self._visits.get(key, 0) + 1
                if capture or visit >= self.CAPTURE_ON_VISIT:
                    entry = self._capture(audio.shape, audio.dtype, mask.shape)
        if entry is None:
            out = self._device_pipeline(audio, mask)
            self.forwards += 1
            return {k: out[k] for k in keys}
        entry.audio.copy_(audio)
        entry.mask.copy_(mask)
        entry.graph.replay()
        self.forwards += 1
        # another replay writes these static outputs, or memory of the
        # shared pool that they lie in: hand back copies
        return {k: entry.out[k].clone() for k in keys}

    def _capture(self, audio_shape, audio_dtype, mask_shape) -> _BucketGraph:
        """Capture the pipeline of one (wire, rows, frames) bucket. One
        capture at a time (a lock); the capture is thread-local, so a
        staging thread may keep copying meanwhile. Its warm-up runs the
        pipeline once eagerly on the capture's stream, which fills every
        first-call cache (the kernels' launch plans and driver entry points,
        cuFFT's plans, cuBLAS's handles and workspaces) so the capture makes
        no first-time host calls.

        Every graph of the engine captures into one memory pool, so the
        graphs hold the largest bucket's working set once, not one each.
        That is safe in any replay order: replays run one after another on
        the compute stream, the static inputs lie outside the pool, each
        graph's static outputs stay allocated while it lives (no later
        capture takes them), and ``run_bucket_staged`` copies them out
        behind the replay, before any other replay can reuse their memory
        for its intermediates."""
        key = (self.wire, *mask_shape)
        with self._capture_lock:
            entry = self._graphs.get(key)
            if entry is not None:
                return entry
            rows, frames = mask_shape
            n_samples = frames * self.hop - 1
            audio = torch.from_numpy(silence_buffer(self.wire, rows, n_samples)).to(self.device)
            if tuple(audio.shape) != tuple(audio_shape) or audio.dtype != audio_dtype:
                raise ValueError(f"wire rows {tuple(audio_shape)} {audio_dtype} do not fit the "
                                 f"{self.wire} bucket ({rows}, {frames}): want "
                                 f"{tuple(audio.shape)} {audio.dtype}")
            mask = torch.zeros(mask_shape, dtype=torch.bool, device=self.device)
            side = self._streams[1]
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._device_pipeline(audio, mask)
            torch.cuda.current_stream(self.device).wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = self._device_pipeline(audio, mask)
            entry = _BucketGraph(audio, mask, graph, out)
            self._graphs[key] = entry
            return entry

    @property
    def graphs_captured(self) -> int:
        return len(self._graphs)

    def run_bucket(self, audio: np.ndarray, frame_mask: np.ndarray) -> dict:
        return self.run_bucket_staged(*self.stage_inputs(audio, frame_mask))

    def assemble(self, device_out: dict, n_frames: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _log_bucket_path(self, n_frames: int) -> None:
        """Say once per bucket which attention path it runs, whether the
        macaron FFNs run fused and whether the products run int8 (stderr:
        stdout belongs to the surfaces' own output)."""
        if not hasattr(self, "_logged_buckets"):
            self._logged_buckets = set()
        if n_frames in self._logged_buckets:
            return
        self._logged_buckets.add(n_frames)
        impl = self.config.get("attention_impl", "auto")
        if impl == "xla" or self.device.type == "cpu":
            path = "plain"
        else:
            path = "splash kernel" if impl == "splash" else "flash kernel"
        int8 = self.model.quant == "int8"
        ffn = ", fused FFN" if self.config.get("fuse_ffn", False) and not int8 else ""
        print(f"| bucket T={n_frames}: attention={path}{ffn}{', int8' if int8 else ''}",
              file=sys.stderr)

    def bucket_groups(self, waveforms: List[np.ndarray]):
        """Native-rate chunks -> (groups, n_parts): each group is (jobs,
        wire rows [rows, wire_width], mask [rows, frames]) of one frame
        bucket, at most max_batch_chunks real rows padded to a row bucket;
        n_parts[i] is how many oversize splits chunk i became.

        Frame counts and splits come from the native length (frames are a
        time-domain quantity). With the half-rate wire the split stride is
        rounded down to the decimation grid, so each piece's wire audio is
        an exact slice of the waveform decimated once, with true filter
        context at every interior seam."""
        buckets = self.frame_buckets
        hop_native = self.hop * self.wire_factor
        max_samples = buckets[-1] * hop_native - 1
        if self.wire_factor > 1:
            from some_tpu_torch.audio.wavio import decimate_wire

            max_samples -= max_samples % self.wire_factor
            wire_waves = [decimate_wire(w, self.wire_factor) for w in waveforms]
        jobs = []
        n_parts = [0] * len(waveforms)
        for i, w in enumerate(waveforms):
            for part, start in enumerate(range(0, max(len(w), 1), max_samples)):
                piece = w[start:start + max_samples]
                n_frames = len(piece) // hop_native + 1
                job = {"idx": i, "part": part, "wave": piece, "frames": n_frames,
                       "bucket": pick_bucket(n_frames, buckets)}
                if self.wire_factor > 1:
                    f = self.wire_factor
                    job["wave"] = wire_waves[i][start // f:-(-(start + len(piece)) // f)]
                jobs.append(job)
                n_parts[i] = part + 1

        by_bucket: Dict[int, list] = {}
        for job in jobs:
            by_bucket.setdefault(job["bucket"], []).append(job)
        groups = []
        for bucket, bucket_jobs in sorted(by_bucket.items()):
            self._log_bucket_path(bucket)
            # the largest sample count that still gives exactly `bucket` frames
            n_samples = bucket * self.hop - 1
            for start in range(0, len(bucket_jobs), self.max_batch_chunks):
                group = bucket_jobs[start:start + self.max_batch_chunks]
                rows = pick_batch_bucket(len(group), self.max_batch_chunks)
                audio = silence_buffer(self.wire, rows, n_samples)
                mask = np.zeros((rows, bucket), dtype=bool)
                for row, job in enumerate(group):
                    # [:n_samples] drops the half-sample ceil tail of a
                    # decimated piece at the bucket edge
                    wave = encode_wire(job["wave"][:n_samples], self.wire)
                    audio[row, :len(wave)] = wave
                    mask[row, :job["frames"]] = True
                groups.append((group, audio, mask))
        return groups, n_parts

    def infer(self, waveforms: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Chunk list -> note dicts, batched per bucket: dispatch every group
        (``dispatch_staged``), then fetch and assemble."""
        self.maybe_reprobe_wire()
        groups, n_parts = self.bucket_groups(waveforms)
        outs = self.dispatch_staged([(audio, mask) for _, audio, mask in groups])
        parts: List[list] = [[None] * n for n in n_parts]
        for (group, _, _), out in zip(groups, outs):
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for row, job in enumerate(group):
                parts[job["idx"]][job["part"]] = self.assemble(
                    {k: v[row] for k, v in out.items()}, job["frames"])
        return [p[0] if len(p) == 1 else self.merge_parts(p) for p in parts]

    def dispatch_staged(self, inputs, depth: int | None = None) -> List[dict]:
        """Host (audio, mask) rows -> device outputs, one ``run_bucket``
        each, in order, none fetched. With ``depth`` (default
        ``_stream_depth()``) above 0 and more than one input, one worker
        thread stages at most ``depth`` inputs' transfers ahead of the one
        being dispatched; 0 stages and runs each in turn."""
        depth = self._stream_depth() if depth is None else depth
        if len(inputs) <= 1 or depth == 0:
            return [self.run_bucket(audio, mask) for audio, mask in inputs]
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        outs = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            staged = deque(pool.submit(self.stage_inputs, *item) for item in inputs[:depth])
            upcoming = iter(inputs[depth:])
            while staged:
                ready = staged.popleft().result()
                item = next(upcoming, None)
                if item is not None:
                    # the worker stages the next input while this one computes
                    staged.append(pool.submit(self.stage_inputs, *item))
                outs.append(self.run_bucket_staged(*ready))
        return outs

    def prewarm(self, frame_buckets, rows=(1, 2, 3, 4, 6, 8), workers: int = 1) -> int:
        """Build the (rows, frames) bucket programs before traffic arrives:
        on the card, capture their graphs (eager dispatch runs each once).
        Rows go through
        ``pick_batch_bucket(r, min(max_batch_chunks, max(rows)))``; the warm
        rows are all padding (mask all-False), so each run decodes to no
        notes. Returns the number of programs touched. The largest go first:
        the graphs' shared pool then holds the largest working set's
        segments, and each smaller capture fits in their free blocks rather
        than add segments of its own. ``workers > 1`` runs them from that
        many threads; captures still go one at a time."""
        programs = []
        for n_frames in frame_buckets:
            if n_frames not in self.frame_buckets:
                raise ValueError(f"{n_frames} is not a frame bucket (have {self.frame_buckets})")
            done = set()
            for r in rows:
                r = pick_batch_bucket(r, min(self.max_batch_chunks, max(rows)))
                if r not in done:
                    done.add(r)
                    programs.append((r, n_frames))
        programs.sort(key=lambda shape: -shape[0] * shape[1])

        def warm_one(shape):
            r, n_frames = shape
            audio = silence_buffer(self.wire, r, n_frames * self.hop - 1)
            mask = np.zeros((r, n_frames), dtype=bool)
            staged = self.stage_inputs(audio, mask)
            self.run_bucket_staged(*staged, capture=True)["n_notes"].cpu()

        if workers > 1 and len(programs) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(warm_one, programs))
        else:
            for shape in programs:
                warm_one(shape)
        return len(programs)

    @staticmethod
    def _stream_depth() -> int:
        """Staging lookahead of infer(): how many groups may have their
        transfer in flight ahead of the current dispatch. 0 = serial, 1 =
        double buffering (default), large = stage everything up front.
        SOME_TPU_STREAM_DEPTH sets it; SOME_TPU_STREAM_GROUPS=0 forces 0."""
        if os.environ.get("SOME_TPU_STREAM_GROUPS") == "0":
            return 0
        try:
            return max(0, int(os.environ.get("SOME_TPU_STREAM_DEPTH", "1")))
        except ValueError:
            return 1

    def merge_parts(self, parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Reassemble one oversize chunk from its splits: plain concatenation;
        subclasses repair the seams."""
        return {k: np.concatenate([d[k] for d in parts]) for k in parts[0]}


# task_cls -> inference engine (some_tpu/registry.py TASK_INFERENCE_MAPPING)
TASK_INFERENCE_MAPPING = {
    "training.MIDIExtractionTask": "some_tpu_torch.inference.me_infer.MIDIExtractionInference",
    "training.QuantizedMIDIExtractionTask":
        "some_tpu_torch.inference.me_quant_infer.QuantizedMIDIExtractionInference",
    "some_tpu.training.me_task.MIDIExtractionTask":
        "some_tpu_torch.inference.me_infer.MIDIExtractionInference",
    "some_tpu.training.me_quant_task.QuantizedMIDIExtractionTask":
        "some_tpu_torch.inference.me_quant_infer.QuantizedMIDIExtractionInference",
}


def build_inference(config: dict, model_path: pathlib.Path | str, **kwargs) -> BaseInference:
    """task_cls -> inference engine."""
    import importlib

    path = TASK_INFERENCE_MAPPING.get(config["task_cls"])
    if path is None:
        raise ValueError(f"no inference engine for task {config['task_cls']!r}")
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)(config, model_path, **kwargs)
