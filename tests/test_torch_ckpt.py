"""Reference Lightning ``.ckpt`` files in the PyTorch port, against the JAX
package's converter and CLI, on the CPU.

The checkpoint is built as ``tests/test_inference.py`` builds it: an
``OracleModel`` (``tests/torch_oracle.py``, the reference's key layout) with
random BatchNorm statistics, saved under Lightning's ``state_dict`` with the
task's ``model.`` prefix, beside pickled objects that are not tensors (as
Lightning writes them), at the small geometry of
``tests/test_torch_infer.py``.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from some_tpu.compat.torch_ckpt import convert_backbone_state_dict as jax_convert
from some_tpu.compat.torch_ckpt import load_torch_checkpoint
from some_tpu.utils.midi_file import MidiFile
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.compat.torch_ckpt import convert_backbone_state_dict, reference_state_dict
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.utils.checkpoint import load_checkpoint, load_state_dict
from some_tpu_torch.utils.midi_file import midi_notes_to_arrays
from some_tpu_torch.utils.note_f1 import note_f1
from tests.test_torch_infer import CONFIG, REPO, songs  # noqa: F401 (a fixture)
from tests.torch_oracle import OracleModel

ARGS = CONFIG["midi_extractor_args"]


class AttributeDict(dict):
    """Stands for Lightning's ``AttributeDict`` of hyper-parameters: a class
    that ``torch.load(weights_only=True)`` refuses."""


def oracle(seed: int = 314159) -> OracleModel:
    torch.manual_seed(seed)
    model = OracleModel(ARGS["lay"], ARGS["dim"], CONFIG["units_dim"], CONFIG["midi_num_bins"],
                        kernel_size=ARGS["kernel_size"], heads=ARGS["attention_heads"],
                        dim_head=ARGS["attention_heads_dim"]).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    return model


def lightning_payload(model: OracleModel, dtype=None) -> dict:
    state = {f"model.{k}": (v if dtype is None or not v.is_floating_point() else v.to(dtype))
             for k, v in model.state_dict().items()}
    state["loss_fn.weight"] = torch.ones(3)  # a key outside the model: dropped
    return {"state_dict": state, "epoch": 3, "global_step": 1000,
            "hyper_parameters": AttributeDict(CONFIG), "callbacks": {}}


@pytest.fixture(scope="module")
def lightning_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("lightning")
    model = oracle()
    torch.save(lightning_payload(model), d / "model.ckpt")
    (d / "config.yaml").write_text(yaml.safe_dump(dict(CONFIG, pl_trainer_precision="32-true")))
    return d / "model.ckpt", model


def test_state_dict_matches_jax_converter(lightning_ckpt):
    """The port's state_dict of the file equals the JAX package's converter
    (``load_torch_checkpoint``, carried across with ``compat/from_jax``) bit
    for bit, fills the model exactly, and keeps the reference's own layouts
    (Linear [out, in], pointwise [out, in], the depthwise taps [k, C])."""
    path, model = lightning_ckpt
    ckpt = load_checkpoint(path)
    assert ckpt["format"] == "torch-converted" and ckpt["optimizer"] is None
    got = ckpt["state_dict"]
    jax_vars = load_torch_checkpoint(path)
    want = jax_params_to_state_dict(jax_vars["params"], jax_vars["batch_stats"])
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32 and torch.equal(got[key], want[key]), key
    port = build_midi_extractor(CONFIG)
    port.load_state_dict(got, strict=True)
    ref = model.state_dict()
    assert torch.equal(got["backbone.in_proj_midi.weight"], ref["model.inln.weight"])
    assert torch.equal(got["backbone.layer_1.bound_gate.weight"], ref["model.cf_lay.1.glu2.0.weight"])
    assert torch.equal(got["backbone.layer_0.midi_block.conv.pw1.weight"],
                       ref["model.cf_lay.0.att1.conv.pointwise_conv1.weight"][:, :, 0])
    assert torch.equal(got["backbone.final_bound.conv.dw.weight"],
                       ref["model.att2.conv.depthwise_conv.weight"][:, 0, :].T)
    assert torch.equal(got["backbone.final_midi.conv.bn.running_var"],
                       ref["model.att1.conv.norm.running_var"])
    assert torch.equal(load_state_dict(path)["backbone.out_proj.bias"], ref["model.outln.bias"])


def test_forward_matches_oracle(lightning_ckpt):
    """The port's f32 forward on the converted weights against
    ``OracleModel``'s on the same input: atol 5e-5, rtol 1e-4 (the JAX
    package's oracle tolerance, tests/test_model.py)."""
    path, model = lightning_ckpt
    port = build_midi_extractor(CONFIG).eval()
    port.load_state_dict(load_state_dict(path), strict=True)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 57, 80)).astype(np.float32))
    mask = torch.ones((2, 57), dtype=torch.bool)
    with torch.no_grad():
        want = model(x, mask=mask, sig=True)
        got = port(x, mask=mask, sig=True)
    for g, w in zip(got, want):
        print(f"port vs OracleModel: max|d| {(g - w).abs().max():.3g}")
        torch.testing.assert_close(g, w, atol=5e-5, rtol=1e-4)


def test_legacy_pickle_half_precision_and_unknown_keys(tmp_path):
    """A legacy-pickle file (``_use_new_zipfile_serialization=False``) loads;
    fp16 and bf16 tensors come back as f32 of the same values; a key under
    the model that no rule knows raises, as the JAX converter does."""
    model = oracle(7)
    for dtype in (None, torch.float16, torch.bfloat16):
        path = tmp_path / f"legacy-{dtype}.ckpt"
        torch.save(lightning_payload(model, dtype), path, _use_new_zipfile_serialization=False)
        assert path.read_bytes()[:2] == b"\x80\x02"
        got = load_state_dict(path)
        ref = model.state_dict()["model.cf_lay.0.att1.ffn1.ln1.weight"]
        want = ref if dtype is None else ref.to(dtype).float()
        assert got["backbone.layer_0.midi_block.ffn1.fc1.weight"].dtype == torch.float32
        assert torch.equal(got["backbone.layer_0.midi_block.ffn1.fc1.weight"], want)
    state = {f"model.{k}": v.numpy() for k, v in model.state_dict().items()}
    state["model.cf_lay.0.att1.ffn1.ln3.weight"] = np.zeros(3, np.float32)
    for convert in (convert_backbone_state_dict, jax_convert):
        with pytest.raises(KeyError, match="unrecognized"):
            convert(state)
    with pytest.raises(KeyError, match="unrecognized"):
        reference_state_dict({"state_dict": {"model.model.decoder.weight": torch.zeros(2)}})


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_cli_gives_the_jax_cli_notes(lightning_ckpt, songs, tmp_path, quantize):  # noqa: F811
    """python -m some_tpu_torch.infer on the Lightning file (its config.yaml
    beside it) against the JAX CLI on the same file, f32: the same notes
    without int8; with ``--quantize int8`` on both, note F1 >= 0.95 (two
    frameworks' f32 an ulp apart round some codes to neighbours; see
    tests/test_torch_quant.py)."""
    from click.testing import CliRunner

    import infer as jax_cli
    from some_tpu_torch.infer import main as port_cli

    path, _ = lightning_ckpt
    f1s = []
    for i, wav in enumerate(songs):
        jax_mid, port_mid = tmp_path / f"jax{i}.mid", tmp_path / f"port{i}.mid"
        result = CliRunner().invoke(jax_cli.infer, ["--model", str(path), "--wav", str(wav),
                                                    "--midi", str(jax_mid),
                                                    "--quantize", quantize])
        assert result.exit_code == 0, result.output
        port_cli(["--model", str(path), "--wav", str(wav), "--midi", str(port_mid),
                  "--quantize", quantize, "--device", "cpu"])
        want, got = MidiFile.load(jax_mid).notes(), MidiFile.load(port_mid).notes()
        assert len(want) > 0
        if quantize == "none":
            assert got == want
        f1s.append(note_f1(midi_notes_to_arrays(MidiFile.load(jax_mid)),
                           midi_notes_to_arrays(MidiFile.load(port_mid)),
                           onset_tolerance=0.05, pitch_tolerance=0.5).f1)
    print(f"port CLI vs JAX CLI on a Lightning file, quantize {quantize}: note F1 {f1s}")
    assert min(f1s) >= 0.95


def test_cli_wire_sr_flag(lightning_ckpt, songs, tmp_path):  # noqa: F811
    """``--wire-sr 22050`` gives the JAX CLI's notes with the same flag."""
    from click.testing import CliRunner

    import infer as jax_cli
    from some_tpu_torch.infer import main as port_cli

    path, _ = lightning_ckpt
    wav = songs[0]
    result = CliRunner().invoke(jax_cli.infer, ["--model", str(path), "--wav", str(wav),
                                                "--midi", str(tmp_path / "jax.mid"),
                                                "--wire-sr", "22050"])
    assert result.exit_code == 0, result.output
    port_cli(["--model", str(path), "--wav", str(wav), "--midi", str(tmp_path / "port.mid"),
              "--wire-sr", "22050", "--device", "cpu"])
    want = MidiFile.load(tmp_path / "jax.mid").notes()
    assert len(want) > 0 and MidiFile.load(tmp_path / "port.mid").notes() == want


def test_cli_runs_on_the_card_by_default(lightning_ckpt, songs):  # noqa: F811
    """Without --device the CLI asks for the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    path, _ = lightning_ckpt
    out = subprocess.run([sys.executable, "-m", "some_tpu_torch.infer", "--model", str(path),
                          "--wav", str(songs[0]), "--quantize", "int8"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
