"""The comparison that decides ``correct`` for served songs.

A served reply holds, per chunk the server cut, its offset and its notes
(pitch, duration, rest). The reference slices the same song, computes the
log-mel and the model in float32, and judges each served chunk by what its
own outputs say of the served decisions:

* ``chunks_off``: served chunks whose offset or frame count differs from
  the reference slicer's (exact; limit 0);
* ``bound_gap``: the widest distance, over every frame, by which the
  reference's running sum of boundary probabilities lies outside the
  interval that the served note boundaries imply (a note starts wherever
  the rounded running sum rises, so after k served notes the sum lies
  within 0.5 of k - 1 + r0, r0 being the rounded first frame); in units of
  boundary probability;
* ``pitch_dev``: the median, over served voiced notes, of the distance
  between the served pitch and the reference's pitch of the same frames
  (the mean of the reference's voiced frame pitches within 0.5 of the
  served note's rounded pitch), in semitones.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.decode import frame_pitch


def served_frames(segment: dict, timestep: float):
    """A served segment -> (frames per note [N] int, pitch [N], rest [N])."""
    dur = np.asarray(segment["note_dur_sec"], np.float64)
    frames = np.round(dur / timestep).astype(np.int64)
    return (frames, np.asarray(segment["note_midi"], np.float64),
            np.asarray(segment["note_rest"], bool))


def bound_gap(bounds: np.ndarray, frames: np.ndarray) -> float:
    """Widest distance of the reference's boundary running sum from the
    served notes' intervals (``frames`` per note, summing to len(bounds))."""
    csum = np.cumsum(bounds.astype(np.float64))
    k = np.repeat(np.arange(len(frames)), frames)  # notes started before each frame, less 1
    best = np.inf
    for r0 in (0, 1):
        gap = np.maximum(np.abs(csum - (k + r0)) - 0.5, 0.0)
        best = min(best, float(gap.max()) if len(gap) else 0.0)
    return best


def pitch_devs(probs: np.ndarray, frames: np.ndarray, pitch: np.ndarray, rest: np.ndarray,
               vmin: float, vmax: float, deviation: float, threshold: float) -> np.ndarray:
    """|served pitch - the reference's pitch of the note's frames| per voiced
    served note (semitones; a note none of whose reference frames lies
    within 0.5 of its rounded pitch reads its distance to the nearest)."""
    ref_pitch, voiced = frame_pitch(probs, vmin, vmax, deviation, threshold)
    out = []
    start = 0
    for n, p, r in zip(frames, pitch, rest):
        seg, v = ref_pitch[start:start + n], voiced[start:start + n]
        start += n
        if r:
            continue
        center = np.round(p)
        near = v & (np.abs(seg - center) <= 0.5)
        if near.any():
            out.append(abs(p - seg[near].mean()))
        else:
            out.append(float(np.min(np.abs(seg - p))) if len(seg) else np.inf)
    return np.asarray(out)


#: the precision below each configuration's, whose reference is the control
CONTROL = {None: "fp8", "int8": "int4"}
#: a served note is off when its pitch lies farther than this from the
#: reference's pitch of its frames (semitones: half a cent)
PITCH_TOL = 0.005


def reference_chunks(wave: np.ndarray, config: dict, model, device) -> list:
    """The reference's own slicing, log-mel and forward of one song:
    [(offset s, probs [T, bins] f64, bounds [T] f64)]."""
    import torch

    from benchmark.reference.frontend import log_mel, slice_song

    sr = config["audio_sample_rate"]
    out = []
    for offset, piece in slice_song(wave, sr):
        mel = log_mel(torch.from_numpy(np.ascontiguousarray(piece)).to(device), sr,
                      config["win_size"], config["hop_size"], config["units_dim"],
                      config["fmin"], config["fmax"]).float()[None]
        logits, bounds = model.forward(mel)
        out.append((offset, torch.sigmoid(logits)[0].double().cpu().numpy(),
                    bounds[0].double().cpu().numpy()))
    return out


def judge_reply(reply: dict, ref: list, config: dict) -> dict:
    """Counts of one served reply against the reference's chunks."""
    from benchmark.reference.decode import decode_notes

    ts = config["hop_size"] / config["audio_sample_rate"]
    dec = (config["midi_min"], config["midi_max"], config["midi_prob_deviation"],
           config["rest_threshold"])
    segments = reply["segments"]
    out = {"chunks": len(ref), "chunks_off": abs(len(segments) - len(ref)), "voiced": 0,
           "pitch_off": 0, "notes_ref": 0, "notes_diff": 0}
    for seg, (offset, probs, bounds) in zip(segments, ref):
        frames, pitch, rest = served_frames(seg, ts)
        n_ref = len(decode_notes(probs, bounds, *dec)[1])
        out["notes_ref"] += n_ref
        if abs(float(seg["offset_sec"]) - offset) > 1e-6 or int(frames.sum()) != len(bounds):
            out["chunks_off"] += 1
            out["notes_diff"] += n_ref
            continue
        out["notes_diff"] += abs(len(frames) - n_ref)
        devs = pitch_devs(probs, frames, pitch, rest, *dec)
        out["voiced"] += len(devs)
        out["pitch_off"] += int((devs > PITCH_TOL).sum())
    return out


def numbers(counts: list) -> dict:
    """The compared numbers over the judged replies' counts."""
    tot = {k: sum(c[k] for c in counts) for k in counts[0]} if counts else {}
    return {"chunks_off": tot.get("chunks_off", 0),
            "pitch_off_share": tot["pitch_off"] / max(tot["voiced"], 1) if tot else 1.0,
            "note_count_dev": tot["notes_diff"] / max(tot["notes_ref"], 1) if tot else 1.0}


def as_reply(ref: list, config: dict) -> dict:
    """A reply in the served schema from reference chunks (the control in
    the program's place)."""
    from benchmark.reference.decode import decode_notes

    ts = config["hop_size"] / config["audio_sample_rate"]
    segs = []
    for offset, probs, bounds in ref:
        pitch, frames, rest = decode_notes(probs, bounds, config["midi_min"], config["midi_max"],
                                           config["midi_prob_deviation"],
                                           config["rest_threshold"])
        segs.append({"offset_sec": offset, "note_midi": pitch.tolist(),
                     "note_dur_sec": (frames * ts).tolist(), "note_rest": rest.tolist()})
    return {"segments": segs}
