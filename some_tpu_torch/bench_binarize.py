"""Binarize throughput of the port: songs a minute and the mel / RMVPE split.

Counterpart of the JAX package's ``tools/bench_binarize.py``. A synthetic
DiffSinger dataset of varied song lengths (sung sines, a rest every fifth
note) goes through ``MIDIExtractionBinarizer`` with ``pe: rmvpe`` and mel
units. RMVPE has random weights from a seed, saved as a ``model.pt`` in the
upstream layout and loaded as a user's would be: the published model's
geometry, so its FLOPs. The timed pass is split into

  units_mel_s      the host mel of the units (key-shift augmentation included)
  rmvpe_s          the whole pitch path (16 kHz mel, forwards, decode, grid)
  rmvpe_forward_s  the forwards alone, the card synchronised after each
  host_other_s     labels, alignment, the HDF5 write, everything else
  hdf5_write_s     of that, the writer's own calls (each item's datasets, the
                   files' metadata at the end)

``rmvpe_programs`` counts the distinct (rows, frames) shapes the forwards
met (each is a cuDNN plan, chosen on first use), ``rmvpe_forwards`` the
forwards. The pass is ``process()``, which writes the HDF5 files with the
port's own codec (``data/hdf5.py``); ``timed_pass(write=False)`` runs all
of ``process()`` but the write (``load``, then ``item_groups`` over both
splits: ``prepare_items`` and ``process_item``; the coverage summary
too), and its line says ``"hdf5_write": false``.

    python -m some_tpu_torch.bench_binarize [--items 8] [--device cpu]

Prints one JSON line with the card's name, power limit and count. Runs on
the card unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import csv
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

SR = 44100
PITCHES = {"A3": 220.0, "C4": 261.6, "E4": 329.6, "G3": 196.0, "B3": 246.9}


def write_song_dataset(root: pathlib.Path, rng, seconds_list) -> float:
    """One sung-sine song a requested length (tools/bench_binarize.py's),
    with its .ds labels and transcriptions.csv; returns the audio seconds."""
    from some_tpu_torch.audio.wavio import save_wav

    wavs = root / "wavs"
    wavs.mkdir(parents=True)
    rows = []
    for i, total in enumerate(seconds_list):
        name = f"song{i}"
        note_seq, note_dur = [], []
        t_acc, k = 0.0, 0
        names = list(PITCHES)
        while t_acc < total - 0.4:
            dur = 0.3 + 0.5 * rng.random()
            note_seq.append("rest" if k % 5 == 4 else names[k % len(names)])
            note_dur.append(round(dur, 3))
            t_acc += dur
            k += 1
        note_dur[-1] = round(note_dur[-1] + (total - t_acc), 3)
        t = np.arange(int(SR * total)) / SR
        freq = np.zeros_like(t)
        t0 = 0.0
        for n, d in zip(note_seq, note_dur):
            if n != "rest":
                freq[(t >= t0) & (t < t0 + d)] = PITCHES[n]
            t0 += d
        vib = 1 + 0.003 * np.sin(2 * np.pi * 5 * t)
        wave = 0.4 * np.sin(2 * np.pi * np.cumsum(freq * vib) / SR)
        wave *= (freq > 0)
        wave += 0.002 * rng.standard_normal(len(wave))
        save_wav(wavs / f"{name}.wav", wave.astype(np.float32), SR)
        ds = [{"note_seq": " ".join(note_seq),
               "note_dur": " ".join(str(d) for d in note_dur),
               "note_slur": " ".join("0" for _ in note_seq)}]
        (wavs / f"{name}.ds").write_text(json.dumps(ds))
        rows.append({"name": name, "ph_seq": " ".join("a" for _ in note_seq),
                     "ph_dur": " ".join(str(d) for d in note_dur),
                     "ph_num": " ".join("1" for _ in note_seq)})
    with open(root / "transcriptions.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["name", "ph_seq", "ph_dur", "ph_num"])
        writer.writeheader()
        writer.writerows(rows)
    return float(sum(seconds_list))


def bench_config(raw: pathlib.Path, binary: pathlib.Path, rmvpe_ckpt, aug: int = 1,
                 units_dim: int = 128) -> dict:
    """tools/bench_binarize.py's binarizer config."""
    return {
        "raw_data_dir": [str(raw)], "binary_data_dir": str(binary),
        "binarization_args": {"num_workers": 0, "shuffle": True, "skip_glide": True,
                              "merge_rest": True, "merge_slur": True, "round_midi": False,
                              "slur_tolerance": 0.5},
        "audio_sample_rate": SR, "hop_size": 512, "win_size": 2048,
        "fmin": 40, "fmax": 8000, "units_dim": units_dim, "units_encoder": "mel",
        "pe": "rmvpe", "pe_ckpt": str(rmvpe_ckpt),
        "key_shift_factor": aug, "key_shift_range": [-3, 3],
        "test_prefixes": ["song0"], "seed": 1, "midi_min": 0, "midi_max": 127,
    }


def save_random_rmvpe(path: pathlib.Path, seed: int = 0) -> pathlib.Path:
    """A random RMVPE ``model.pt`` in the upstream layout ({"model": state})."""
    from some_tpu_torch.nn.rmvpe import random_state_dict

    torch.save({"model": random_state_dict(seed)}, path)
    return path


def timed_pass(config: dict, device, write: bool = True):
    """One binarize pass with the split timed, on the path the binarizer
    runs (bucketed, batched RMVPE forwards); returns (the numbers,
    {prefix: [item groups]}, the items as ``process_item`` made them, also
    those the pass wrote)."""
    from some_tpu_torch.data.indexed_dataset import IndexedDatasetWriter
    from some_tpu_torch.nn.rmvpe import RMVPE
    from some_tpu_torch.preprocessing.me_binarizer import MIDIExtractionBinarizer

    device = torch.device(device)
    rmvpe = RMVPE.cached(config["pe_ckpt"], device=device)
    acc = {"units": 0.0, "rmvpe": 0.0, "fwd": 0.0, "write": 0.0}
    shapes, forwards = set(), []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            acc[key] += time.perf_counter() - t0
            return out
        return wrapper

    def counted_forward(mel, t_valid):
        shapes.add(mel.shape[:2])
        forwards.append(mel.shape[:2])
        t0 = time.perf_counter()
        out = RMVPE._forward(rmvpe, mel, t_valid)
        sync()
        acc["fwd"] += time.perf_counter() - t0
        return out

    binarizer = MIDIExtractionBinarizer(dict(config), device=str(device))
    binarizer.compute_units = timed(binarizer.compute_units, "units")
    rmvpe._forward = counted_forward
    rmvpe.get_pitch = timed(rmvpe.get_pitch, "rmvpe")
    rmvpe.f0_batch = timed(rmvpe.f0_batch, "rmvpe")
    to_grid = RMVPE.__dict__["f0_to_grid"]
    # the grid resample runs outside f0_batch, from the cache
    RMVPE.f0_to_grid = staticmethod(timed(to_grid.__func__, "rmvpe"))
    writer_calls = {name: getattr(IndexedDatasetWriter, name) for name in ("add_item", "finalize")}
    for name, fn in writer_calls.items():
        setattr(IndexedDatasetWriter, name, timed(fn, "write"))
    groups = {}
    item_groups = binarizer.item_groups

    def kept_groups(prefix, *args, **kwargs):
        for group in item_groups(prefix, *args, **kwargs):
            groups.setdefault(prefix, []).append(group)
            yield group

    try:
        t0 = time.perf_counter()
        if write:
            binarizer.item_groups = kept_groups
            binarizer.process()
        else:
            binarizer.load()
            binarizer.binary_data_dir.mkdir(parents=True, exist_ok=True)
            binarizer.check_coverage()
            for prefix, aug in (("valid", False), ("train", True)):
                groups[prefix] = list(binarizer.item_groups(prefix, apply_augmentation=aug))
        sync()
        wall = time.perf_counter() - t0
    finally:
        RMVPE.f0_to_grid = to_grid
        for name, fn in writer_calls.items():
            setattr(IndexedDatasetWriter, name, fn)
        for name in ("_forward", "get_pitch", "f0_batch"):
            rmvpe.__dict__.pop(name, None)
    return {"wall_s": wall, "units_mel_s": acc["units"], "rmvpe_s": acc["rmvpe"],
            "rmvpe_forward_s": acc["fwd"],
            "host_other_s": wall - acc["units"] - acc["rmvpe"], "hdf5_write_s": acc["write"],
            "rmvpe_programs": len(shapes), "rmvpe_forwards": len(forwards),
            "rmvpe_shapes": sorted(str(s) for s in shapes), "hdf5_write": write}, groups


def measure(device=None, items: int = 8, min_s: float = 4.0, max_s: float = 30.0,
            aug: int = 1, seed: int = 42) -> dict:
    """The bench's line of one pass in a fresh process's state (each
    RMVPE shape met for the first time)."""
    from some_tpu_torch.inference.base_infer import resolve_device

    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="some_tpu_torch_bench_binarize_") as tmp:
        root = pathlib.Path(tmp)
        seconds = list(np.round(np.linspace(min_s, max_s, items), 1))
        audio_s = write_song_dataset(root / "raw", np.random.default_rng(seed), seconds)
        ckpt = save_random_rmvpe(root / "model.pt", seed)
        config = bench_config(root / "raw", root / "binary", ckpt, aug)
        stats = timed_pass(config, device)[0]
    return bench_line(stats, items, audio_s, device, aug_factor=aug)


def bench_line(stats: dict, items: int, audio_s: float, device, **flags) -> dict:
    """The bench's JSON line of one ``timed_pass``; ``device`` names the
    card (``bench.card``: nvidia-smi's name and power limit, the count)."""
    from some_tpu_torch.bench import card

    return {"metric": "binarize_rtf", "value": audio_s / stats["wall_s"],
            "unit": "audio-sec/sec, raw -> items incl. RMVPE pitch",
            "songs_per_min": items / stats["wall_s"] * 60, "items": items,
            "audio_seconds": audio_s, **stats, **flags,
            "device": card() if torch.device(device).type == "cuda" else "cpu"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Binarize throughput of some_tpu_torch")
    ap.add_argument("--items", type=int, default=8)
    ap.add_argument("--min-s", type=float, default=4.0)
    ap.add_argument("--max-s", type=float, default=30.0)
    ap.add_argument("--aug", type=int, default=1, help="key_shift_factor")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for a test)")
    args = ap.parse_args(argv)
    line = measure(args.device, items=args.items, min_s=args.min_s, max_s=args.max_s,
                   aug=args.aug)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
