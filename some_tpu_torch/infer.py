"""Single-WAV inference CLI: waveform -> silence slicing -> model -> MIDI.

Counterpart of the JAX package's ``infer.py``. The model checkpoint is the
port's own (``torch.save``), a native SOME-TPU msgpack checkpoint, or a
reference Lightning ``.ckpt``; its ``config.yaml`` sits beside it. Runs on
the GPU unless ``--device cpu``. ``--quantize int8`` serves the int8 model
(``ops/quant.py``), ``--wire-sr`` sends the audio to the card decimated to
that rate. The JAX CLI's ``--devices`` (a data-parallel mesh) has no
counterpart on one card.

    python -m some_tpu_torch.infer --model CKPT --wav in.wav [--midi out.mid]
        [--quantize none|int8] [--wire-sr 22050] [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib

from some_tpu_torch.audio.wavio import load_wav
from some_tpu_torch.config import load_yaml, print_config
from some_tpu_torch.inference.base_infer import build_inference
from some_tpu_torch.inference.pipeline import transcribe_waveform


def load_engine(model_path: pathlib.Path | str, device=None, quiet: bool = False,
                quantize: str | None = None, wire_sr: int | None = None):
    """The inference engine for a checkpoint and the config.yaml beside it;
    ``quantize`` and ``wire_sr`` override the config's keys."""
    model_path = pathlib.Path(model_path)
    config = load_yaml(model_path.with_name("config.yaml"))
    if quantize is not None:
        config["quantize"] = quantize
    if wire_sr is not None:
        config["wire_sr"] = wire_sr
    if not quiet:
        print_config(config)
    return build_inference(config, model_path, device=device)


def transcribe_file(engine, wav, midi=None, tempo: float = 120) -> pathlib.Path:
    """One WAV through the engine into a MIDI file; returns its path."""
    wav_path = pathlib.Path(wav)
    sr = engine.config["audio_sample_rate"]
    waveform, _ = load_wav(wav_path, sr=sr, mono=True)
    midi_path = pathlib.Path(midi) if midi is not None else wav_path.with_suffix(".mid")
    transcribe_waveform(engine, waveform, sr, tempo=tempo).save(midi_path)
    return midi_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run inference with a trained model")
    parser.add_argument("--model", required=True, metavar="CKPT_PATH",
                        help="path to the model checkpoint")
    parser.add_argument("--wav", required=True, metavar="WAV_PATH", help="input wav file")
    parser.add_argument("--midi", metavar="MIDI_PATH", help="output MIDI file")
    parser.add_argument("--tempo", type=float, default=120, help="tempo of the output MIDI")
    parser.add_argument("--quantize", choices=("none", "int8"), default=None,
                        help="serving quantization (default: the config's, else none)")
    parser.add_argument("--wire-sr", type=int, default=None,
                        help="decimate the audio sent to the device to this rate (e.g. 22050)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    engine = load_engine(args.model, device=args.device, quantize=args.quantize,
                         wire_sr=args.wire_sr)
    midi_path = transcribe_file(engine, args.wav, args.midi, args.tempo)
    print(f"MIDI file saved at: '{midi_path}'")


if __name__ == "__main__":
    main()
