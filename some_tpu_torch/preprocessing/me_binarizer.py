"""MIDI-extraction binarizer: DiffSinger labels -> binarized training items.

Port of ``some_tpu/preprocessing/me_binarizer.py``; the same numpy calls in
the same order, so items equal the JAX package's array for array (with
``pe: rmvpe``, pitch to RMVPE's tolerance). RMVPE and ContentVec run on the
binarizer's ``device``. Pipeline parity with the reference (reference: preprocessing/me_binarizer.py):
transcriptions.csv + per-item .ds JSON -> glide skip -> note normalization
(cents) -> slur/rest merging -> mel units (host MelSpec with float key-shift
augmentation) -> pitch curve -> rest-pitch nearest interpolation -> note
durations to frames -> unit2note alignment -> HDF5 items.

Units come from the host mel (arbitrary float key shifts need dynamic n_fft,
a host concern by design; see some_tpu_torch/audio/mel.py) or ContentVec;
everything stored is plain numpy.
"""
from __future__ import annotations

import csv
import json
import math
import pathlib
import random
from typing import List

import numpy as np

from some_tpu_torch.audio.mel import MelSpec
from some_tpu_torch.audio.pitch_extract import extract_pitch
from some_tpu_torch.audio.wavio import load_wav
from some_tpu_torch.preprocessing.base_binarizer import BaseBinarizer
from some_tpu_torch.preprocessing.label_utils import (
    durations_to_alignment, durations_to_frames, merge_rests, merge_slurs,
)
from some_tpu_torch.utils.note_names import hz_to_midi, midi_to_note, note_to_midi

MIDI_EXTRACTION_ITEM_ATTRIBUTES = [
    "units",      # log-mel (or contentvec) units, float32 [T_s, C]
    "pitch",      # actual pitch in semitones, float32 [T_s]
    "note_midi",  # note-level MIDI pitch, float32 [T_n]
    "note_rest",  # rest flags, bool [T_n]
    "note_dur",   # note durations in frames, int64 [T_n]
    "unit2note",  # frame -> note alignment (mel2ph format), int64 [T_s]
]


class MIDIExtractionBinarizer(BaseBinarizer):
    def __init__(self, config: dict, device=None):
        super().__init__(config, data_attrs=MIDI_EXTRACTION_ITEM_ATTRIBUTES, device=device)
        args = self.binarization_args
        self.skip_glide = args.get("skip_glide", True)
        self.merge_rest = args.get("merge_rest", True)
        self.merge_slur = args.get("merge_slur", True)
        self.slur_tolerance = args.get("slur_tolerance")
        self.round_midi = args.get("round_midi", False)
        self.key_shift_min, self.key_shift_max = config.get("key_shift_range", [-12, 12])
        self.key_shift_factor = config.get("key_shift_factor", 0)
        self._mel: MelSpec | None = None

    # ---- metadata ----
    def load_meta_data(self, raw_data_dir: pathlib.Path, ds_id: int) -> None:
        csv_path = raw_data_dir / "transcriptions.csv"
        if not csv_path.exists():
            raise FileNotFoundError(f"transcriptions.csv not found in {raw_data_dir}.")
        loaded = {}
        with open(csv_path, "r", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                item_name = row["name"]
                ds_path = raw_data_dir / "wavs" / f"{item_name}.ds"
                with open(ds_path, "r", encoding="utf8") as df:
                    ds = json.load(df)
                if isinstance(ds, list):
                    ds = ds[0]
                if self.skip_glide and ds.get("note_glide") is not None and any(
                        g != "none" for g in ds["note_glide"].split()):
                    print(f"Item {ds_id}:{item_name} contains glide notes. Skipping.")
                    continue
                note_seq = [
                    midi_to_note(
                        np.clip(note_to_midi(n, round_midi=self.round_midi), 0, 127),
                        cents=not self.round_midi, unicode=False,
                    ) if n != "rest" else "rest"
                    for n in ds["note_seq"].split()
                ]
                note_slur = [bool(int(s)) for s in ds["note_slur"].split()]
                note_dur = [float(x) for x in ds["note_dur"].split()]
                assert len(note_seq) == len(note_slur) == len(note_dur), \
                    f"Lengths of note_seq/note_slur/note_dur mismatch in '{item_name}'."
                assert any(n != "rest" for n in note_seq), \
                    f"All notes are rest in '{item_name}'."

                if self.merge_slur:
                    note_seq, note_dur = merge_slurs(
                        note_seq, note_dur, note_slur, tolerance=self.slur_tolerance)
                if self.merge_rest:
                    note_seq, note_dur = merge_rests(note_seq, note_dur)

                loaded[f"{ds_id}:{item_name}"] = {
                    "wav_fn": str(raw_data_dir / "wavs" / f"{item_name}.wav"),
                    "note_seq": note_seq,
                    "note_dur": note_dur,
                }
        self.items.update(loaded)

    def check_coverage(self) -> None:
        """MIDI pitch distribution summary + figure
        (reference: me_binarizer.py:108-144)."""
        midi_map: dict = {}
        for item in self.items.values():
            for name in item["note_seq"]:
                if name == "rest":
                    continue
                midi = note_to_midi(name, round_midi=True)
                midi_map[midi] = midi_map.get(midi, 0) + 1
        if not midi_map:
            return
        print("===== MIDI Pitch Distribution Summary =====")
        keys = sorted(midi_map)
        for i, key in enumerate(keys):
            end = "\n" if (i == len(keys) - 1 or i % 10 == 9) else ", "
            print(f"'{midi_to_note(key, unicode=False)}': {midi_map[key]}", end=end)
        try:
            from some_tpu_torch.utils.plot import distribution_to_figure
            notes = [midi_to_note(m, unicode=False)
                     for m in range(keys[0], keys[-1] + 1)]
            fig = distribution_to_figure(
                title="MIDI Pitch Distribution Summary",
                x_label="MIDI Key", y_label="Number of occurrences",
                items=notes,
                values=[midi_map.get(m, 0) for m in range(keys[0], keys[-1] + 1)])
        except ImportError as exc:  # no matplotlib: the figure is optional
            print(f"| distribution figure skipped: {exc}")
            return
        out = self.binary_data_dir / "midi_distribution.jpg"
        fig.savefig(fname=out, bbox_inches="tight", pad_inches=0.25)
        print(f"| save summary to '{out}'")

    # ---- per-item processing ----
    def _mel_spec(self) -> MelSpec:
        if self._mel is None:
            self._mel = MelSpec(
                n_mels=self.config["units_dim"],
                sample_rate=self.config["audio_sample_rate"],
                win_length=self.config["win_size"], hop_length=self.config["hop_size"],
                fmin=self.config["fmin"], fmax=self.config["fmax"])
        return self._mel

    def compute_units(self, waveform: np.ndarray, keyshift: float = 0.0) -> np.ndarray:
        encoder = self.config["units_encoder"]
        if encoder == "mel":
            return self._mel_spec()(waveform, keyshift=keyshift).astype(np.float32)
        if encoder == "contentvec768l12":
            from some_tpu_torch.nn.contentvec import ContentVecEncoder
            cv = ContentVecEncoder.cached(self.config["units_encoder_ckpt"], device=self.device)
            return cv(waveform, sample_rate=self.config["audio_sample_rate"])
        raise NotImplementedError(f"Invalid units encoder: {encoder}")

    def prepare_items(self, args) -> None:
        """Serial-path batch hook (base_binarizer.process_dataset): for
        pe=rmvpe, run the whole split's pitch forwards bucket-BATCHED
        (RMVPE.f0_batch) and cache each item's 10 ms f0 curve, so the
        per-item path pays only the cheap grid resample. Groups of 32 bound
        peak mel RAM; a cache entry is popped as it is consumed."""
        if self.config.get("pe", "yin") != "rmvpe" or not args:
            return
        from some_tpu_torch.nn.rmvpe import RMVPE
        try:
            rmvpe = RMVPE.cached(self.config.get("pe_ckpt"), device=self.device)
        except FileNotFoundError:
            return  # no checkpoint file: extract_pitch falls back per item (yin)
        self._f0_cache = getattr(self, "_f0_cache", {})
        sr = self.config["audio_sample_rate"]
        group = 32
        for pos in range(0, len(args), group):
            chunk = args[pos:pos + group]
            names, waves = [], []
            for name, meta, _aug in chunk:
                # An unreadable wav must not abort the whole split here,
                # before any item is written: skip caching it, so the
                # per-item path fails (or falls back) WITH item context at
                # its own turn in the loop. Each waveform is
                # decoded again by process_item — an accepted duplicate
                # (~2x wav IO on the serial path): caching a whole group's
                # decoded audio would hold ~170 MB peak, and wav decode +
                # resample is a few percent of the pitch forward it feeds.
                try:
                    waveform, _ = load_wav(meta["wav_fn"], sr=sr, mono=True)
                except Exception:
                    continue
                names.append(name)
                waves.append(waveform)
            for name, f0 in zip(names, rmvpe.f0_batch(waves, sr)):
                self._f0_cache[name] = f0

    def _extract_pitch(self, item_name, waveform, length) -> np.ndarray:
        cached = getattr(self, "_f0_cache", {}).pop(item_name, None)
        if cached is not None:
            from some_tpu_torch.nn.rmvpe import RMVPE
            f0, _ = RMVPE.f0_to_grid(
                cached, self.config["audio_sample_rate"],
                self.config["hop_size"], length, interp_uv=True)
            return f0
        f0, _ = extract_pitch(
            self.config.get("pe", "yin"), waveform,
            sample_rate=self.config["audio_sample_rate"],
            hop_size=self.config["hop_size"], length=length, interp_uv=True,
            rmvpe_ckpt=self.config.get("pe_ckpt"), device=self.device)
        return f0

    def _process_item(self, waveform: np.ndarray, meta_data: dict,
                      int_midi: bool = False, item_name: str = None) -> dict:
        units = self.compute_units(waveform)
        assert units.ndim == 2 and units.shape[1] == self.config["units_dim"], \
            f"Shape of units must be [T, units_dim], got {units.shape}."
        length = units.shape[0]
        seconds = length * self.timestep
        item = {"seconds": seconds, "length": length, "units": units}

        f0 = self._extract_pitch(item_name, waveform, length)
        item["pitch"] = hz_to_midi(f0).astype(np.float32)

        note_midi = np.array(
            [(note_to_midi(n, round_midi=int_midi) if n != "rest" else -1)
             for n in meta_data["note_seq"]],
            dtype=np.int64 if int_midi else np.float32)
        note_rest = note_midi < 0
        # nearest-voiced interpolation over rest slots
        voiced_idx = np.where(~note_rest)[0]
        rest_idx = np.where(note_rest)[0]
        if len(rest_idx):
            nearest = voiced_idx[np.abs(rest_idx[:, None] - voiced_idx[None, :])
                                 .argmin(axis=1)]
            note_midi[rest_idx] = note_midi[nearest]
        item["note_midi"] = note_midi
        item["note_rest"] = note_rest

        durs = np.asarray(meta_data["note_dur"], dtype=np.float64)
        item["note_dur"] = durations_to_frames(durs, self.timestep)
        item["unit2note"] = durations_to_alignment(durs, length, self.timestep)
        return item

    def _effective_shift_range(self, note_midi):
        """Clamp the configured key-shift range so every shifted label stays
        inside [midi_min, midi_max]. The reference shifts unclipped
        (me_binarizer.py:246), which can push labels out of the bin/class
        range — torch CE would crash loudly, but a jitted gather clamps
        SILENTLY, so out-of-range labels must never be produced.

        Returns (lo, hi), or None when no shift is possible (item already
        spans the whole label range) — callers skip augmentation rather than
        emit key_shift_factor byte-identical copies of the base item."""
        midi_min = float(self.config.get("midi_min", 0))
        midi_max = float(self.config.get("midi_max", 127))
        voiced = np.asarray(note_midi, np.float64)
        if voiced.size == 0:
            return None
        lo = max(float(self.key_shift_min), midi_min - float(voiced.min()))
        hi = min(float(self.key_shift_max), midi_max - float(voiced.max()))
        if lo > hi:  # item spans more than the label range allows
            return None
        return lo, hi

    def process_item(self, item_name: str, meta_data: dict,
                     allow_aug: bool = False) -> List[dict]:
        waveform, _ = load_wav(meta_data["wav_fn"],
                               sr=self.config["audio_sample_rate"], mono=True)
        base = self._process_item(waveform, meta_data, int_midi=False,
                                  item_name=item_name)
        items = [base]
        if not allow_aug:
            return items
        # Per-item seeded RNG: binarized datasets are reproducible run-to-run
        # (the reference draws from the global RNG, me_binarizer.py:237, so
        # its augmented shifts differ every run — deliberate improvement).
        rng = random.Random(f"{self.config.get('seed', 0)}:{item_name}")
        shift_range = self._effective_shift_range(base["note_midi"])
        if shift_range is None:
            return items
        lo, hi = shift_range
        if self.round_midi:
            # integer bounds, like the quant binarizer: round(draw) could
            # otherwise land 0.5 outside the clamped range (e.g. lo=-3.6,
            # draw -3.51 rounds to -4) — the silent label-range escape the
            # clamp exists to prevent
            lo_i, hi_i = math.ceil(lo), math.floor(hi)
            if lo_i > hi_i:  # float range contains no integer shift
                return items
        for _ in range(self.key_shift_factor):
            assert self.config["units_encoder"] == "mel", \
                "Units encoder must be mel if augmentation is applied!"
            if self.round_midi:
                shift = rng.randint(lo_i, hi_i)
            else:
                shift = rng.random() * (hi - lo) + lo
            aug = dict(base)
            aug["units"] = self.compute_units(waveform, keyshift=shift)
            aug["pitch"] = base["pitch"] + shift
            aug["note_midi"] = base["note_midi"] + shift
            items.append(aug)
        return items
