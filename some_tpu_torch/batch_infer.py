"""Batch inference over a DiffSinger dataset: label ``transcriptions.csv``
with ``note_seq``/``note_dur`` aligned to word boundaries.

Counterpart of the JAX package's ``batch_infer.py``: slice each WAV, infer
its notes, flatten the chunks to absolute time, snap note edges to the word
boundaries that ``ph_dur``/``ph_num`` give (within 50 ms), then fill each
word either with the note of largest overlap (``--round_midi``) or with
every overlapping note plus rest padding.

    python -m some_tpu_torch.batch_infer --dataset RAW_DATA_DIR --model CKPT
        [--round_midi] [--csv OUT.csv] [--overwrite] [--device cpu]

Runs on the card unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import pathlib
from csv import DictReader, DictWriter
from typing import List

from some_tpu_torch.audio.wavio import load_wav
from some_tpu_torch.infer import load_engine
from some_tpu_torch.inference.pipeline import slice_waveform
from some_tpu_torch.utils.note_names import midi_to_note


def calc_seq(note_midi: float, note_rest: bool) -> str:
    """float MIDI -> 'NoteName(+/-cents)' label."""
    if note_rest:
        return "rest"
    midi_num = round(note_midi, 0)
    cent = int(round(note_midi - midi_num, 2) * 100)
    cent_str = f"+{cent}" if cent > 0 else (str(cent) if cent < 0 else "")
    return f"{midi_to_note(midi_num, unicode=False)}{cent_str}"


def infer_song(wav_path, engine, config) -> List[dict]:
    """One WAV -> its notes in absolute time."""
    waveform, _ = load_wav(wav_path, sr=config["audio_sample_rate"], mono=True)
    chunks = slice_waveform(waveform, config["audio_sample_rate"])
    segments = engine.infer([c["waveform"] for c in chunks])

    res: List[dict] = []
    for chunk, segment in zip(chunks, segments):
        offset = round(chunk["offset"], 6)
        last_time = 0.0
        for mid, dur, rest in zip(segment["note_midi"].tolist(), segment["note_dur"].tolist(),
                                  segment["note_rest"].tolist()):
            dur = round(dur, 6)
            last_time = round(last_time, 6)
            info = {
                "start_time": round(offset + last_time, 6),
                "end_time": round(offset + last_time + dur, 6),
                "note_seq": calc_seq(mid, rest),
            }
            if res and info["start_time"] < res[-1]["end_time"]:
                info["start_time"] = res[-1]["end_time"]
            info["note_dur"] = round(info["end_time"] - info["start_time"], 6)
            res.append(info)
            last_time += dur
    return res


def word_windows(ph_durs: List[float], ph_nums: List[int]):
    """Word time windows from phoneme durations."""
    windows = []
    cursor = 0
    start = 0.0
    for count in ph_nums:
        word_dur = round(sum(ph_durs[cursor:cursor + count]), 6)
        windows.append((round(start, 6), round(start + word_dur, 6)))
        cursor += count
        start += word_dur
    return windows


def align_to_words(notes: List[dict], windows, tolerance: float = 0.05) -> List[dict]:
    """Snap note edges to word bounds within +-tolerance; drop notes left
    with no duration."""
    bounds = [w[0] for w in windows] + [windows[-1][1]]
    out = []
    for note in notes:
        for b in bounds:
            if b - tolerance <= note["start_time"] <= b + tolerance:
                note["start_time"] = b
            if b - tolerance <= note["end_time"] <= b + tolerance:
                note["end_time"] = b
        note["note_dur"] = round(note["end_time"] - note["start_time"], 6)
        if note["note_dur"] > 0:
            out.append(note)
    return out


def overlapping_notes(interval, notes):
    """All notes overlapping a word window."""
    lo, hi = interval
    out = []
    for n in notes:
        if (lo < n["start_time"] < hi or lo < n["end_time"] < hi
                or (n["start_time"] <= lo and hi <= n["end_time"])):
            out.append(n)
    return out


def max_overlap_note(interval, notes) -> str:
    """Label of the note with the largest overlap, or 'rest'."""
    best, best_overlap = "rest", 0.0
    for n in notes:
        overlap = max(0.0, min(interval[1], n["end_time"]) - max(interval[0], n["start_time"]))
        if overlap > best_overlap:
            best_overlap = overlap
            best = n["note_seq"]
    return best


def label_row(row: dict, notes: List[dict], round_midi: bool) -> None:
    """Fill row['note_seq'] and row['note_dur'] from the note list."""
    ph_dur = [round(float(x), 6) for x in row["ph_dur"].split(" ")]
    ph_num = [int(x) for x in row["ph_num"].split(" ")]
    windows = word_windows(ph_dur, ph_num)
    notes = align_to_words(notes, windows)

    note_seq: List[str] = []
    note_dur: List[float] = []
    for (start, end) in windows:
        word_dur = round(end - start, 6)
        if round_midi:
            note_seq.append(max_overlap_note((start, end), notes))
            note_dur.append(word_dur)
            continue
        seq: List[str] = []
        durs: List[float] = []
        for note in overlapping_notes((start, end), notes):
            seq.append(note["note_seq"])
            if note["start_time"] <= start:
                durs.append(round(min(end, note["end_time"]) - start, 6))
            elif note["end_time"] >= end:
                durs.append(round(end - max(start, note["start_time"]), 6))
            else:
                durs.append(round(note["note_dur"], 6))
        if not seq:
            seq.append("rest")
            durs.append(word_dur)
        if round(sum(durs), 6) < word_dur:
            seq.append("rest")
            durs.append(word_dur - round(sum(durs), 6))
        note_seq.extend(seq)
        note_dur.extend(durs)

    if len(note_seq) != len(note_dur):
        raise AssertionError(f"{len(note_seq)} notes against {len(note_dur)} durations")
    row["note_seq"] = " ".join(str(x) for x in note_seq)
    row["note_dur"] = " ".join(str(round(x, 6)) for x in note_dur)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Batch inference on an existing DiffSinger "
                                                 "dataset.")
    parser.add_argument("--dataset", required=True, metavar="RAW_DATA_DIR",
                        help="dataset directory (the DiffSinger raw_data_dir)")
    parser.add_argument("--model", required=True, metavar="CKPT_PATH",
                        help="path to the model checkpoint (config.yaml beside it)")
    parser.add_argument("--round_midi", action="store_true",
                        help="one note a word: the one of largest overlap")
    parser.add_argument("--csv", metavar="CSV_PATH",
                        help="output transcriptions.csv (default: the dataset's)")
    parser.add_argument("--overwrite", action="store_true", help="overwrite an existing csv")
    parser.add_argument("--devices", type=int, default=1,
                        help="serve over a mesh of N engine replicas (cuda:0..N-1, or N on "
                             "the CPU with --device cpu)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)

    data_path = pathlib.Path(args.dataset)
    csv_path = pathlib.Path(args.csv) if args.csv is not None else data_path / "transcriptions.csv"
    if csv_path.exists() and not args.overwrite:
        raise FileExistsError(f"The CSV path '{csv_path}' already exists. Re-try with "
                              "--overwrite.")
    engine = load_engine(args.model, device=args.device, devices=args.devices)
    config = engine.config

    with open(data_path / "transcriptions.csv", "r", encoding="utf8", newline="") as f:
        rows = list(DictReader(f))

    for i, row in enumerate(rows):
        wav = data_path / "wavs" / f"{row['name']}.wav"
        if not wav.exists():
            print(f"WARNING: audio file does not exist: '{wav}'")
            continue
        label_row(row, infer_song(wav, engine, config), args.round_midi)
        print(f"| {i + 1}/{len(rows)} {row['name']}", flush=True)

    with open(csv_path, "w", encoding="utf8", newline="") as f:
        writer = DictWriter(f, fieldnames=["name", "ph_seq", "ph_dur", "ph_num", "note_seq",
                                           "note_dur"])
        writer.writeheader()
        writer.writerows(rows)


if __name__ == "__main__":
    main()
