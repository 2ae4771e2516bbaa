"""The port's stdlib web UI (some_tpu_torch/webui.py) end to end over HTTP,
as tests/test_webui.py drives the JAX package's: the form lists the
checkpoints of the work dir, an upload comes back as a MIDI file, here equal
byte for byte to the JAX web UI's on the same checkpoint in f32; a bad
upload or an unknown checkpoint comes back as the form with an error."""
import io
import pathlib
import threading
import urllib.request
import uuid

import numpy as np
import pytest
import yaml

from some_tpu.audio.wavio import save_wav
from some_tpu_torch.utils.midi_file import MidiFile
from some_tpu_torch.webui import WebUI, make_stdlib_server
from tests.test_inference import TINY_MODEL_CONFIG, synth


@pytest.fixture(scope="module")
def work_dir(tmp_path_factory):
    import jax

    from some_tpu.nn.model import build_midi_extractor
    from some_tpu.training.checkpoint import save_checkpoint

    wd = tmp_path_factory.mktemp("webui_work")
    config = dict(TINY_MODEL_CONFIG, pl_trainer_precision="32-true")
    variables = build_midi_extractor(config).init(jax.random.PRNGKey(0),
                                                  np.zeros((1, 32, 80), np.float32))
    save_checkpoint(wd, 100, variables["params"], variables.get("batch_stats"))
    (wd / "config.yaml").write_text(yaml.safe_dump(config))
    return wd


def multipart(fields: dict, file_field: str, file_bytes: bytes):
    boundary = uuid.uuid4().hex
    body = io.BytesIO()
    for name, value in fields.items():
        body.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                   f"name=\"{name}\"\r\n\r\n{value}\r\n".encode())
    body.write(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{file_field}\"; "
               f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n".encode())
    body.write(file_bytes)
    body.write(f"\r\n--{boundary}--\r\n".encode())
    return body.getvalue(), boundary


def post_form(port, fields, wav_bytes):
    body, boundary = multipart(fields, "audio", wav_bytes)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.headers["Content-Type"], resp.read()


def test_stdlib_webui_roundtrip(work_dir, tmp_path):
    import webui as jax_webui

    ui = WebUI(work_dir, device="cpu")
    choices = ui.choices()
    assert choices == ["model_ckpt_steps_100.ckpt"]
    server = make_stdlib_server(ui, 0, "127.0.0.1")
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read().decode()
        assert choices[0] in page and "multipart/form-data" in page

        wav_path = tmp_path / "in.wav"
        save_wav(wav_path, synth(2.0, 440), 44100)
        ctype, data = post_form(port, {"model": choices[0], "tempo": "120"},
                                wav_path.read_bytes())
        assert ctype == "audio/midi"
        out = tmp_path / "out.mid"
        out.write_bytes(data)
        assert MidiFile.load(out).ticks_per_beat == 480

        # the JAX web UI's handler on the same checkpoint and upload
        jax_webui._work_dir = pathlib.Path(work_dir)
        jax_mid, status = jax_webui.transcribe(choices[0], str(wav_path), 120.0)
        assert jax_mid is not None, status
        assert data == pathlib.Path(jax_mid).read_bytes()

        ctype, page = post_form(port, {"model": choices[0], "tempo": "120"}, b"not a wav")
        assert ctype.startswith("text/html") and b"unsupported or corrupt" in page
        ctype, page = post_form(port, {"model": "../elsewhere.ckpt", "tempo": "120"},
                                wav_path.read_bytes())
        assert b"unknown checkpoint" in page
    finally:
        server.shutdown()
        server.server_close()


def test_cli_needs_a_card_one_device_and_a_work_dir(work_dir, tmp_path, monkeypatch):
    import torch

    from some_tpu_torch.webui import main

    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"not present \\({torch.cuda.device_count()} CUDA"):
        main(["--devices", str(n), "--work_dir", str(work_dir)])
    # two CPU replicas serve an upload: the one-replica UI's MIDI bytes
    wav = tmp_path / "song.wav"
    save_wav(wav, synth(3.0, 440, seed=4), 44100)
    written = []
    for devices in (1, 2):
        ui = WebUI(work_dir, device="cpu", devices=devices)
        midi, status = ui.transcribe(ui.choices()[0], str(wav), 120)
        assert midi is not None, status
        assert len(ui.get_engine(ui.choices()[0]).replicas) == devices
        written.append(pathlib.Path(midi).read_bytes())
    assert written[0] == written[1]
    with pytest.raises(FileNotFoundError, match="No checkpoints"):
        main(["--work_dir", str(tmp_path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--work_dir", str(work_dir)])
