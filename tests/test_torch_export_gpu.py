"""The kernel ops of ``ops/library.py`` and the exported programs on the card.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_export_gpu.py -q -m gpu

Every test is marked ``gpu`` and skips without a card. Each op's CUDA
implementation (the hand-written kernel, counted) is held against its plain
version at PERF.md's kernel tolerances (chip_smoke.py's): K1 bit for bit,
K2, K3 and K4 within ``attention_tolerance``, ``fused_ffn_tolerance`` and
``splash_forward_tolerance``. Then a program exported on the card, of the
model cut to 2 dual-stream layers at production width (6 conformer blocks),
is loaded and run: its launches a forward, and its outputs against the
engine's eager dispatch of the same bucket.
"""
import numpy as np
import pytest
import torch

from chip_smoke import attention_tolerance, fused_ffn_tolerance, splash_forward_tolerance
from test_torch_engine_gpu import BLOCKS, CONFIG, CONFIGS, PER_FORWARD, tone

from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
from some_tpu_torch.deployment.export import MIDIExtractionExporter, load_exported
from some_tpu_torch.inference.base_infer import set_dispatch
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.ops import attention as A
from some_tpu_torch.ops import depthwise as W
from some_tpu_torch.ops import fused_ffn as K3
from some_tpu_torch.ops import library

pytestmark = pytest.mark.gpu

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state():
    variables = random_jax_variables(build_midi_extractor(CONFIG), seed=1618)
    return jax_params_to_state_dict(variables["params"], variables["batch_stats"])


def op_inputs(name, dtype, device, T=512, real=431):
    """A main-path call of each op: [1, T, 512] activations, 8 x 64 heads,
    the first ``real`` frames real."""
    gen = torch.Generator(device=device).manual_seed(T + real)
    randn = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    mask = (torch.arange(T, device=device) < real)[None]
    if name == "depthwise_conv1d":
        return randn(1, T, 512).to(dtype), (0.2 * randn(31, 512)).to(dtype)
    if name in ("flash_attention", "splash_attention"):
        # strided [B, H, T, D] views of [B, T, H, D] projections, as the model passes them
        q, k, v = (randn(1, T, 8, 64).to(dtype).transpose(1, 2) for _ in range(3))
        return q, k, v, mask, 64 ** -0.5
    D, H = 512, 2048
    return (randn(1, T, D).to(dtype), 1.0 + 0.1 * randn(D), 0.1 * randn(D),
            randn(H, D).t() * D ** -0.5, 0.1 * randn(H), randn(D, H).t() * H ** -0.5,
            0.1 * randn(D), 1e-5, 0.5)


PLAIN = {name: impls[0] for name, impls in library.IMPLS.items()}
COUNTERS = {"depthwise_conv1d": W.depthwise_conv1d, "flash_attention": A.flash_attention,
            "splash_attention": A.splash_attention,
            "fused_ln_ffn_residual": K3.fused_ln_ffn_residual}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PLAIN))
def test_op_runs_the_kernel_within_the_plain_tolerance(cuda, name, dtype):
    args = op_inputs(name, DTYPES[dtype], cuda)
    counter = COUNTERS[name]
    before = counter.launches
    with torch.inference_mode():
        got = getattr(torch.ops.some_tpu, name)(*args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        want = PLAIN[name](*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    if name == "depthwise_conv1d":
        assert torch.equal(got, want)
        return
    tol = {"flash_attention": attention_tolerance, "splash_attention": splash_forward_tolerance,
           "fused_ln_ffn_residual": fused_ffn_tolerance}[name](torch, want)
    ratio = float(((got.float() - want.float()).abs() / tol).max())
    print(f"{name} {dtype}: max |d|/tol {ratio:.4f}")
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_opcheck_on_the_card(cuda, name):
    """``torch.library.opcheck`` with CUDA samples: the fake implementation
    gives the kernel's output layout ([B, T, H, D] storage for attention)."""
    library.register_fakes()
    torch.library.opcheck(getattr(torch.ops.some_tpu, name).default,
                          op_inputs(name, torch.bfloat16, cuda, T=256, real=200))


@pytest.mark.parametrize("config", ["default", "opt_in", "default_int8"])
def test_loaded_program_launches_the_kernels(cuda, state, tmp_path, config):
    """Export bucket 512 on the card in bf16, load it, run a song: each
    forward of the loaded program launches its configuration's kernels once
    a block (K3 twice), and its outputs equal the engine's eager dispatch of
    the bucket (probs and bounds bit for bit, note_midi to f32 rounding)."""
    base, int8 = config.removesuffix("_int8"), config.endswith("_int8")
    overrides = dict(CONFIGS[base], pl_trainer_precision="bf16",
                     **({"quantize": "int8"} if int8 else {}))
    per_forward = dict(PER_FORWARD[base])
    if int8:
        per_forward.pop("fused_ln_ffn_residual", None)
    MIDIExtractionExporter(dict(CONFIG, **overrides), state_dict=state,
                           device="cuda").export(tmp_path, buckets=(512,))
    pipeline = load_exported(tmp_path)
    eager = MIDIExtractionInference.from_state_dict(dict(CONFIG, **overrides,
                                                         transfer_dtype="float32"),
                                                    state, device="cuda")
    set_dispatch(eager, "eager")
    wave = tone(5.5, 330, 3)
    _, audio, mask = eager.bucket_groups([wave])[0][0]
    assert mask.shape == (1, 512)
    for fn in COUNTERS.values():
        fn.launches = 0
    for forward in (1, 2):
        got = pipeline.run_bucket(audio, mask)
        torch.cuda.synchronize()
        launched = {name: fn.launches for name, fn in COUNTERS.items() if fn.launches}
        assert launched == {n: forward * c for n, c in per_forward.items()}
    want = eager.run_bucket_staged(*eager.stage_inputs(audio, mask), frames=True)
    for key in ("probs", "bounds", "n_notes", "note_dur", "note_rest"):
        assert torch.equal(got[key], want[key]), key
    torch.testing.assert_close(got["note_midi"], want["note_midi"], rtol=0, atol=1e-4)
    notes = pipeline(wave)
    assert len(notes["note_dur"]) == int(want["n_notes"][0]) > 0
    assert BLOCKS == 6
    assert np.isfinite(notes["note_midi"]).all()
