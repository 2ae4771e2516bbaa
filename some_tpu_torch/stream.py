"""Live transcription CLI: raw PCM on stdin -> NDJSON note events on stdout.

Counterpart of the JAX package's ``stream.py``, over
``inference/streaming.py``'s ``StreamingTranscriber``. Example:

    ffmpeg -i mic.wav -f s16le -ac 1 -ar 44100 - | \\
        python -m some_tpu_torch.stream --model experiments/model.ckpt

Each completed phrase prints one JSON line the moment the silence scan
decides that the phrase is over:

    {"offset_sec": 12.48, "note_midi": [...], "note_dur_sec": [...],
     "note_rest": [...]}

With ``--midi PATH`` the accumulated song is also written as an SMF file at
the end of the stream. Runs on the card unless ``--device cpu``; without a
card it raises.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading

import numpy as np

from some_tpu_torch.infer import load_engine, parse_buckets
from some_tpu_torch.inference.pipeline import segment_to_json
from some_tpu_torch.inference.streaming import StreamingTranscriber

#: Frame buckets a live stream prewarms by default: a phrase longer than
#: 4096 frames (~47 s of singing without a pause) is left to a first-visit
#: capture.
MAX_PREWARM_FRAMES = 4096


def refuse_devices(devices: int) -> None:
    """Refuse ``--devices`` above 1: the JAX package's stream CLI has no
    mesh, and a live stream feeds one phrase at a time."""
    if devices > 1:
        raise NotImplementedError(f"--devices {devices}: the stream CLI serves on one device")


def event_line(event) -> str:
    return json.dumps(segment_to_json(event["offset"], event["segment"]))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Stream raw mono PCM from stdin; print note "
                                                 "events as NDJSON the moment each phrase "
                                                 "completes.")
    parser.add_argument("--model", required=True, help="checkpoint (config.yaml beside it)")
    parser.add_argument("--pcm-format", choices=("s16le", "f32le"), default="s16le",
                        help="wire format of the stdin samples (mono, at the model's rate)")
    parser.add_argument("--chunk-ms", type=float, default=100.0,
                        help="how much audio to read per iteration")
    parser.add_argument("--midi", metavar="MIDI_PATH",
                        help="also write the accumulated SMF here at the end of the stream")
    parser.add_argument("--tempo", type=float, default=120)
    parser.add_argument("--prewarm", action=argparse.BooleanOptionalAction, default=True,
                        help="capture every (frame bucket x 1-2 rows) graph before reading "
                             "stdin, so no capture lands on the live path")
    parser.add_argument("--prewarm-buckets", default=None, metavar="T1,T2,..",
                        help="prewarm only these frame buckets (default: every bucket <= "
                             f"{MAX_PREWARM_FRAMES} frames)")
    parser.add_argument("--devices", type=int, default=1,
                        help="cards to serve on: one (a live stream runs one phrase at a time)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    refuse_devices(args.devices)
    engine = load_engine(args.model, device=args.device, quiet=True)

    sr = engine.config["audio_sample_rate"]
    itemsize = 2 if args.pcm_format == "s16le" else 4
    chunk_bytes = max(itemsize, int(sr * args.chunk_ms / 1000) * itemsize)

    # Drain stdin from a thread started before the prewarm: a plain-pipe
    # caller cannot wait for the ready marker, and a blocked pipe would stall
    # the source for the whole warm-up. Mono PCM is ~5 MB a minute at
    # 44.1 kHz s16, so what buffers meanwhile stays small.
    chunks_q: "queue.Queue[bytes]" = queue.Queue()

    def drain_stdin():
        stdin = sys.stdin.buffer
        while True:
            data = stdin.read(chunk_bytes)
            chunks_q.put(data)
            if not data:  # the EOF sentinel stays in the queue
                return

    threading.Thread(target=drain_stdin, daemon=True).start()

    if args.prewarm:
        # rows (1, 2): the live path feeds one phrase at a time; an
        # oversize phrase splits into rows, which row bucketing rounds to 2+
        buckets = (parse_buckets(args.prewarm_buckets) if args.prewarm_buckets
                   else [b for b in engine.frame_buckets if b <= MAX_PREWARM_FRAMES])
        print("| prewarming bucket programs before accepting audio...", file=sys.stderr,
              flush=True)
        n = engine.prewarm(buckets, rows=(1, 2))
        print(f"| prewarmed {n} bucket programs", file=sys.stderr, flush=True)
    st = StreamingTranscriber(engine)
    # the readiness marker: a caller can wait for it before opening the source
    print("| ready (awaiting stdin)", file=sys.stderr, flush=True)

    pending = b""
    while True:
        data = chunks_q.get()
        if not data:
            break
        pending += data
        usable = len(pending) - len(pending) % itemsize
        if not usable:
            continue
        raw, pending = pending[:usable], pending[usable:]
        if args.pcm_format == "s16le":
            pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        else:
            pcm = np.frombuffer(raw, "<f4").astype(np.float32)
        for event in st.feed(pcm):
            print(event_line(event), flush=True)
    for event in st.flush():
        print(event_line(event), flush=True)

    if args.midi is not None:
        st.to_midi(tempo=args.tempo).save(args.midi)
        print(f"MIDI file saved at: '{args.midi}'", file=sys.stderr)


if __name__ == "__main__":
    main()
