"""Live streaming transcription: incremental PCM in, note events out.

Counterpart of ``some_tpu/inference/streaming.py``. The offline silence
slicer's scan is a left-to-right algorithm with O(1) decision state
(``_SliceScanner`` in ``audio/slicer.py``), so the stream drives the same
scan incrementally: chunk boundaries, and so the notes, are those of the
whole file through the offline pipeline. A phrase is emitted as soon as the
scan decides that the silence after it is a split point, so the latency is
about the trailing silence the slicer must observe (min_interval to
max_sil_kept), the RMS lookahead (win/2) and one engine dispatch, which on
the card replays a captured bucket graph.

Divergence from offline: inputs no longer than the slicer's min_length
(default 5 s) take the offline early return (one unsliced chunk), which
needs the total length up front; the stream runs the ordinary scan. Feed
longer audio than min_length for exact equivalence.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from some_tpu_torch.audio.slicer import SilenceSlicer, _SliceScanner
from some_tpu_torch.inference.pipeline import MAX_SIL_KEPT_MS
from some_tpu_torch.utils.midi_file import build_midi_file


class _GrowBuffer:
    """Amortized-doubling sample buffer addressed by ABSOLUTE index.

    `append` adds samples at the end; `consume_to(i)` declares samples below
    absolute index i dead so their storage can be reclaimed (a live stream
    must not retain every sample ever fed — phrases already emitted and RMS
    windows already scanned can never be referenced again). len() stays the
    absolute total fed, and `slice(a, b)` reads by absolute coordinates, so
    callers are oblivious to reclamation."""

    def __init__(self, dtype=np.float32, capacity: int = 1 << 16):
        self._a = np.zeros(capacity, dtype)
        self._base = 0   # absolute index of _a[0]
        self._n = 0      # live samples currently stored

    def append(self, x: np.ndarray) -> None:
        need = self._n + len(x)
        if need > len(self._a):
            cap = len(self._a)
            while cap < need:
                cap *= 2
            grown = np.zeros(cap, self._a.dtype)
            grown[:self._n] = self._a[:self._n]
            self._a = grown
        self._a[self._n:need] = x
        self._n = need

    def consume_to(self, abs_idx: int) -> None:
        drop = min(abs_idx, self._base + self._n) - self._base
        # amortize: memmove only when a meaningful prefix is dead
        if drop >= 1 << 15:
            self._a[:self._n - drop] = self._a[drop:self._n]
            self._n -= drop
            self._base += drop

    def __len__(self) -> int:
        """Absolute total number of samples ever appended."""
        return self._base + self._n

    def slice(self, start: int, end: int) -> np.ndarray:
        """View of [start, end) in absolute coordinates (must be live)."""
        if start < self._base:
            raise IndexError(f"slice at {start} reads below the live region at {self._base}")
        return self._a[start - self._base:end - self._base]

    def nbytes(self) -> int:
        return self._a.nbytes


class StreamingTranscriber:
    """Incremental wav->notes over a prepared inference engine.

    Usage::

        st = StreamingTranscriber(engine)
        for pcm in source:              # float32 mono at the model's rate
            for ev in st.feed(pcm):     # events as phrases complete
                print(ev["offset"], ev["segment"]["note_midi"])
        events += st.flush()
        midi = st.to_midi(tempo=120)    # everything emitted so far
    """

    def __init__(self, engine, slicer: SilenceSlicer | None = None):
        self.engine = engine
        self.sr = int(engine.config["audio_sample_rate"])
        self.slicer = slicer or SilenceSlicer(
            sr=self.sr, max_sil_kept=MAX_SIL_KEPT_MS)
        self._scanner = _SliceScanner(
            self.slicer.threshold, self.slicer.min_interval,
            self.slicer.min_length, self.slicer.max_sil_kept)
        self._buf = _GrowBuffer()
        # prefix sums of squared samples: _sq absolute index j holds
        # sum(y[0..j]^2) accumulated in strict arrival order
        self._sq = _GrowBuffer(dtype=np.float64)
        self._acc = 0.0              # last prefix value (f64 chain carry)
        self._win = self.slicer.win_size
        self._hop = self.slicer.hop_size
        self._pad = self._win // 2
        self._next_frame = 0         # next RMS frame index to compute
        self._prev_tag_end = None    # frame where the next chunk starts
        self._saw_tag = False
        self._finished = False
        self._offsets: List[float] = []
        self._segments: List[dict] = []

    # -- incremental RMS (bit-exact twin of audio/slicer.rms_envelope) -----
    #
    # Both offline envelopes (python rms_envelope and the native C++ scan)
    # compute a SEQUENTIAL float64 cumulative sum of squares and difference
    # it per frame. Sequential f64 addition is order-determined, so seeding
    # np.cumsum of each new block with the running carry reproduces the
    # offline prefix values bit-for-bit — a direct per-frame np.dot would
    # differ in low-order bits (the offline cumsum carries cancellation
    # error the dot does not), and a frame near the -40 dB threshold or an
    # argmin near-tie would then resolve differently, breaking the
    # stream-equals-offline guarantee on audio with a real noise floor.

    def _append_prefix(self, x: np.ndarray) -> None:
        sq = x.astype(np.float64)
        np.multiply(sq, sq, out=sq)
        seeded = np.cumsum(np.concatenate(([self._acc], sq)))
        self._sq.append(seeded[1:])
        self._acc = float(seeded[-1])

    def _prefix(self, j: int) -> float:
        """Offline csum value at absolute sample index j (sum of first j
        squared samples); zero-padding outside the signal adds exact 0.0."""
        if j <= 0:
            return 0.0
        return float(self._sq.slice(j - 1, j)[0])

    def _frame_rms(self, k: int, n_total: int) -> float:
        start = k * self._hop - self._pad
        end = min(n_total, start + self._win)
        power = (self._prefix(end) - self._prefix(start)) / self._win
        return math.sqrt(power)

    def _available_frames(self) -> int:
        """Frames whose full window (incl. right edge) is already buffered."""
        n = len(self._buf)
        return max(0, (n + self._pad - self._win) // self._hop + 1)

    def _total_frames(self) -> int:
        """Offline frame count for the whole stream (with both edge pads)."""
        n = len(self._buf)
        padded = n + 2 * self._pad
        return 0 if padded < self._win else (padded - self._win) // self._hop + 1

    # -- chunk plumbing ----------------------------------------------------

    def _chunk_events(self, begin_f: int, end_f: int) -> List[dict]:
        begin = begin_f * self._hop
        end = min(len(self._buf), end_f * self._hop)
        wave = self._buf.slice(begin, end).copy()
        [segment] = self.engine.infer([wave])
        event = {"offset": begin / self.sr, "segment": segment}
        self._offsets.append(event["offset"])
        self._segments.append(segment)
        return [event]

    def _on_tags(self, tags, final_total=None) -> List[dict]:
        events: List[dict] = []
        for tag in tags:
            if not self._saw_tag:
                self._saw_tag = True
                if tag[0] > 0:
                    events += self._chunk_events(0, tag[0])
            else:
                events += self._chunk_events(self._prev_tag_end, tag[0])
            self._prev_tag_end = tag[1]
        if final_total is not None:
            if not self._saw_tag:
                if len(self._buf):
                    events += self._chunk_events(0, final_total)
            elif self._prev_tag_end < final_total:
                events += self._chunk_events(self._prev_tag_end, final_total)
        return events

    # -- public API --------------------------------------------------------

    def _compact(self) -> None:
        """Reclaim storage nothing can reference again: PCM before the next
        chunk's start, prefix sums before the next RMS window, and the
        scanner's old RMS frames. Bounds a live stream's footprint to the
        current phrase instead of the whole session."""
        chunk_start = (self._prev_tag_end * self._hop) if self._saw_tag else 0
        self._buf.consume_to(chunk_start)
        self._sq.consume_to(max(0, self._next_frame * self._hop
                                - self._pad - 1))
        self._scanner.compact()

    def feed(self, pcm: np.ndarray) -> List[dict]:
        """Append mono float32 samples; returns events for every phrase the
        slicer completed with this data."""
        if self._finished:
            raise RuntimeError("flush() already called")
        x = np.asarray(pcm, np.float32).reshape(-1)
        self._buf.append(x)
        self._append_prefix(x)
        avail = self._available_frames()
        n = len(self._buf)
        levels = [self._frame_rms(k, n) for k in range(self._next_frame, avail)]
        self._next_frame = avail
        events = self._on_tags(self._scanner.feed(levels))
        self._compact()
        return events

    def flush(self) -> List[dict]:
        """End of stream: run the edge-padded tail frames and the trailing-
        silence rule, emit every remaining phrase."""
        if self._finished:
            return []
        self._finished = True
        total = self._total_frames()
        n = len(self._buf)
        levels = [self._frame_rms(k, n) for k in range(self._next_frame, total)]
        self._next_frame = total
        tags = self._scanner.feed(levels)
        tags.extend(self._scanner.finish())
        return self._on_tags(tags, final_total=total)

    def to_midi(self, tempo: float = 120):
        """SMF of everything emitted so far (call after flush for the full
        stream)."""
        return build_midi_file(self._offsets, self._segments, tempo=tempo)
