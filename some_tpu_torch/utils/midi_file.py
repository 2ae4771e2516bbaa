"""Minimal Standard MIDI File (SMF) writer/reader.

Copy of ``some_tpu/utils/midi_file.py``: a single-track format-1 file at 480
PPQ with one ``set_tempo`` meta event and note_on/note_off pairs.
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

TICKS_PER_BEAT = 480


def _encode_varlen(value: int) -> bytes:
    """MIDI variable-length quantity encoding."""
    if value < 0:
        raise ValueError(f"negative delta time: {value}")
    buf = [value & 0x7F]
    value >>= 7
    while value:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(buf))


def _decode_varlen(data: bytes, pos: int):
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def bpm_to_tempo(bpm: float) -> int:
    """Beats-per-minute -> microseconds per beat (mido.bpm2tempo)."""
    return int(round(60.0 * 1e6 / bpm))


@dataclass
class MidiEvent:
    delta: int          # ticks since previous event
    kind: str           # 'note_on' | 'note_off' | 'set_tempo'
    note: int = 0
    velocity: int = 64
    tempo: int = 500000


@dataclass
class MidiFile:
    events: List[MidiEvent] = field(default_factory=list)
    ticks_per_beat: int = TICKS_PER_BEAT

    def add_tempo(self, bpm: float, delta: int = 0) -> None:
        self.events.append(MidiEvent(delta=delta, kind="set_tempo", tempo=bpm_to_tempo(bpm)))

    def add_note_on(self, note: int, delta: int, velocity: int = 64) -> None:
        self.events.append(MidiEvent(delta=delta, kind="note_on", note=note, velocity=velocity))

    def add_note_off(self, note: int, delta: int, velocity: int = 64) -> None:
        self.events.append(MidiEvent(delta=delta, kind="note_off", note=note, velocity=velocity))

    def _track_bytes(self) -> bytes:
        out = bytearray()
        for ev in self.events:
            out += _encode_varlen(ev.delta)
            if ev.kind == "set_tempo":
                out += bytes([0xFF, 0x51, 0x03])
                out += ev.tempo.to_bytes(3, "big")
            elif ev.kind == "note_on":
                out += bytes([0x90, ev.note & 0x7F, ev.velocity & 0x7F])
            elif ev.kind == "note_off":
                out += bytes([0x80, ev.note & 0x7F, ev.velocity & 0x7F])
            else:
                raise ValueError(f"unknown event kind {ev.kind}")
        out += bytes([0x00, 0xFF, 0x2F, 0x00])  # end of track
        return bytes(out)

    def serialize(self) -> bytes:
        """The complete SMF byte stream (format 1, one track)."""
        track = self._track_bytes()
        return b"".join([
            b"MThd", (6).to_bytes(4, "big"),
            (1).to_bytes(2, "big"),                             # format 1
            (1).to_bytes(2, "big"),                             # one track
            self.ticks_per_beat.to_bytes(2, "big"),
            b"MTrk", len(track).to_bytes(4, "big"), track,
        ])

    def save(self, path: pathlib.Path | str) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    @classmethod
    def load(cls, path: pathlib.Path | str) -> "MidiFile":
        """Parse a single/multi-track SMF back into a flat event list (tests)."""
        data = pathlib.Path(path).read_bytes()
        if data[:4] != b"MThd":
            raise ValueError(f"{path}: not a MIDI file")
        ticks_per_beat = int.from_bytes(data[12:14], "big")
        ntrks = int.from_bytes(data[10:12], "big")
        mf = cls(ticks_per_beat=ticks_per_beat)
        pos = 8 + int.from_bytes(data[4:8], "big")
        for _ in range(ntrks):
            if data[pos:pos + 4] != b"MTrk":
                raise ValueError(f"{path}: track {_} has no MTrk header")
            tlen = int.from_bytes(data[pos + 4:pos + 8], "big")
            tpos, tend = pos + 8, pos + 8 + tlen
            status = 0
            while tpos < tend:
                delta, tpos = _decode_varlen(data, tpos)
                byte = data[tpos]
                if byte & 0x80:
                    status = byte
                    tpos += 1
                if status == 0xFF:  # meta
                    meta_type = data[tpos]
                    mlen, mdatapos = _decode_varlen(data, tpos + 1)
                    if meta_type == 0x51:
                        tempo = int.from_bytes(data[mdatapos:mdatapos + 3], "big")
                        mf.events.append(MidiEvent(delta=delta, kind="set_tempo", tempo=tempo))
                    tpos = mdatapos + mlen
                elif status & 0xF0 in (0x90, 0x80):
                    note, vel = data[tpos], data[tpos + 1]
                    kind = "note_on" if (status & 0xF0) == 0x90 and vel > 0 else "note_off"
                    mf.events.append(MidiEvent(delta=delta, kind=kind, note=note, velocity=vel))
                    tpos += 2
                elif status & 0xF0 in (0xC0, 0xD0):
                    tpos += 1
                else:
                    tpos += 2
            pos = tend
        return mf

    def notes(self) -> List[dict]:
        """Flatten to [{note, start_tick, end_tick}] for comparisons."""
        out, pending, tick = [], {}, 0
        for ev in self.events:
            tick += ev.delta
            if ev.kind == "note_on":
                pending[ev.note] = tick
            elif ev.kind == "note_off" and ev.note in pending:
                out.append({"note": ev.note, "start_tick": pending.pop(ev.note),
                            "end_tick": tick})
        return out


def build_midi_file(offsets: List[float], segments: List[Dict[str, np.ndarray]],
                    tempo: float = 120) -> MidiFile:
    """Assemble per-chunk note dicts into one MIDI file.

    Semantics match the reference assembler (reference:
    utils/infer_utils.py:79-100): tick = round(sec * tempo * 8) i.e. 480 PPQ,
    notes clamped at the next chunk's offset, rest notes skipped.
    """
    mf = MidiFile()
    mf.add_tempo(tempo)
    last_time = 0
    tick_offsets = [round(o * tempo * 8) for o in offsets]
    for i, (offset, segment) in enumerate(zip(tick_offsets, segments)):
        note_midi = np.round(segment["note_midi"]).astype(np.int64).tolist()
        note_tick = np.diff(
            np.round(np.cumsum(segment["note_dur"]) * tempo * 8).astype(np.int64),
            prepend=0,
        ).tolist()
        note_rest = segment["note_rest"].tolist()
        start = offset
        for j in range(len(note_midi)):
            end = start + note_tick[j]
            if i < len(tick_offsets) - 1 and end > tick_offsets[i + 1]:
                end = tick_offsets[i + 1]
            if start < end and not note_rest[j]:
                mf.add_note_on(note_midi[j], delta=start - last_time)
                mf.add_note_off(note_midi[j], delta=end - start)
                last_time = end
            start = end
    return mf


def midi_notes_to_arrays(midi: MidiFile, tempo: float = 120.0):
    """(onsets, offsets, pitches) in seconds, the input of ``note_f1``
    (``tools/compare_midi.py`` in the JAX package)."""
    ticks_per_sec = midi.ticks_per_beat * tempo / 60.0
    notes = midi.notes()
    on = np.array([n["start_tick"] / ticks_per_sec for n in notes])
    off = np.array([n["end_tick"] / ticks_per_sec for n in notes])
    pitch = np.array([float(n["note"]) for n in notes])
    return on, off, pitch
