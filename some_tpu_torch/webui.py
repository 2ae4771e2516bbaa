"""Web UI for interactive transcription, on the standard library.

Counterpart of the JAX package's ``webui.py`` in its stdlib form
(``_launch_stdlib``): a form with a checkpoint list over ``--work_dir``, an
audio upload and a tempo field; the reply is the MIDI file, or the form
again with an error. The multipart body is parsed with ``email``. The JAX
package's gradio launcher has no counterpart here.

    python -m some_tpu_torch.webui [--work_dir experiments] [--port 7860] [--device cpu]

Runs on the card unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import email
import email.policy
import pathlib
import tempfile
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, Optional, Tuple

from some_tpu_torch.audio.wavio import load_wav
from some_tpu_torch.infer import load_engine, make_serving_mesh
from some_tpu_torch.inference.base_infer import resolve_device
from some_tpu_torch.inference.pipeline import MAX_DURATION_SEC, transcribe_waveform

PAGE = """<!doctype html><title>SOME-TPU</title>
<h2>SOME-TPU: Singing-Oriented MIDI Extractor</h2>
<form method=post enctype=multipart/form-data>
<p>Checkpoint: <select name=model>{options}</select></p>
<p>Audio (wav): <input type=file name=audio></p>
<p>Tempo: <input type=number name=tempo value=120 min=20 max=200></p>
<p><input type=submit value=Transcribe></p></form>
<p>{status}</p>"""


class WebUI:
    """The checkpoints under ``work_dir`` and one engine per checkpoint,
    loaded at its first request (over ``devices`` replicas above 1)."""

    def __init__(self, work_dir: pathlib.Path | str, device=None, devices: int = 1):
        self.work_dir = pathlib.Path(work_dir)
        self.device = device
        self.devices = devices
        self.engines: Dict[str, object] = {}

    def choices(self) -> list:
        return sorted(p.relative_to(self.work_dir).as_posix()
                      for p in self.work_dir.rglob("*.ckpt"))

    def get_engine(self, model_rel_path: str):
        if model_rel_path not in self.engines:
            self.engines[model_rel_path] = load_engine(self.work_dir / model_rel_path,
                                                       device=self.device, quiet=True,
                                                       devices=self.devices)
        return self.engines[model_rel_path]

    def transcribe(self, model_rel_path: str, audio_path: str,
                   tempo: Optional[float]) -> Tuple[Optional[pathlib.Path], str]:
        """(the MIDI file written beside the audio, or None; a status line)."""
        if not model_rel_path or not audio_path or tempo is None:
            return None, "Error: required inputs not specified."
        if model_rel_path not in self.choices():
            return None, f"Error: unknown checkpoint: {model_rel_path}"
        engine = self.get_engine(model_rel_path)
        sr = engine.config["audio_sample_rate"]
        try:
            waveform, _ = load_wav(audio_path, sr=sr, mono=True)
        except Exception:  # any decode failure of an upload is the user's
            return None, f"Error: unsupported or corrupt file: {audio_path}"
        total_duration = len(waveform) / sr
        if total_duration > MAX_DURATION_SEC:
            return None, "Error: the input audio is too long (>= 20 minutes)."

        start = time.time()
        midi_file = transcribe_waveform(engine, waveform, sr, tempo=tempo)
        infer_time = time.time() - start
        rtf = infer_time / max(total_duration, 1e-9)
        print(f"RTF: {rtf}")
        out_path = pathlib.Path(audio_path).with_suffix(".mid")
        midi_file.save(out_path)
        return out_path, f"Cost {round(infer_time, 2)} s, RTF: {round(rtf, 3)}"


def make_stdlib_server(ui: WebUI, port: int, addr: str | None = None) -> HTTPServer:
    """The form's HTTP server, bound but not started."""
    choices = ui.choices()

    class Handler(BaseHTTPRequestHandler):
        def _render(self, status=""):
            options = "".join(f"<option>{c}</option>" for c in choices)
            body = PAGE.format(options=options, status=status).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._render()

        def do_POST(self):
            length = int(self.headers["Content-Length"])
            raw = (b"Content-Type: " + self.headers["Content-Type"].encode()
                   + b"\r\n\r\n" + self.rfile.read(length))
            msg = email.message_from_bytes(raw, policy=email.policy.HTTP)
            fields = {}
            audio_bytes = None
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if name == "audio":
                    audio_bytes = part.get_payload(decode=True)
                else:
                    fields[name] = part.get_payload(decode=True).decode().strip()
            if not audio_bytes:
                return self._render("Error: no audio uploaded.")
            try:
                tempo = float(fields.get("tempo", 120))
            except ValueError:
                return self._render("Error: the tempo must be a number.")
            with tempfile.TemporaryDirectory(prefix="some_tpu_torch_webui_") as tmp:
                wav_path = pathlib.Path(tmp) / "upload.wav"
                wav_path.write_bytes(audio_bytes)
                midi_path, status = ui.transcribe(fields.get("model"), str(wav_path), tempo)
                if midi_path is None:
                    return self._render(status)
                data = midi_path.read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", "audio/midi")
            self.send_header("Content-Disposition", 'attachment; filename="output.mid"')
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    return HTTPServer((addr or "0.0.0.0", port), Handler)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Launch the web UI for inference")
    parser.add_argument("--port", type=int, default=7860, help="server port")
    parser.add_argument("--addr", default=None, help="server address")
    parser.add_argument("--work_dir", default=None,
                        help="directory of the experiments (default: ./experiments)")
    parser.add_argument("--devices", type=int, default=1,
                        help="serve over a mesh of N engine replicas (cuda:0..N-1, or N on "
                             "the CPU with --device cpu)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    # no card and no --device, or fewer cards than --devices: raise before serving
    make_serving_mesh(args.devices, args.device)
    resolve_device(args.device)
    work_dir = pathlib.Path(args.work_dir or "experiments")
    if not work_dir.is_dir():
        raise NotADirectoryError(f"{work_dir} is not a directory.")
    ui = WebUI(work_dir, device=args.device, devices=args.devices)
    if not ui.choices():
        raise FileNotFoundError(f"No checkpoints found in {work_dir}.")
    server = make_stdlib_server(ui, args.port, args.addr)
    print(f"| serving the web UI on {args.addr or '0.0.0.0'}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
