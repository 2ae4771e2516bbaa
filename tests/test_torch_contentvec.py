"""ContentVec / HuBERT units encoder of the PyTorch port against the JAX
package, on the CPU: the narrow encoder of tests/test_contentvec.py (2
conv layers, dim 32, 3 layers, output layer 2) on weights from the JAX
init carried across by ``contentvec_params_to_state_dict``; the padded,
masked forward against the unpadded one; the fairseq- and Hugging Face-
layout converters; and ``ContentVecEncoder`` on a fairseq-layout file at
full HuBERT-base width (two layers) against the JAX package's. Held to
atol 5e-5 / rtol 1e-4, as tests/test_contentvec.py holds JAX to its oracle
(2e-5 / 1e-4 for padded against unpadded)."""
import jax
import numpy as np
import pytest
import torch

from some_tpu.nn import contentvec as J
from some_tpu_torch.compat.from_jax import contentvec_params_to_state_dict
from some_tpu_torch.nn import contentvec as C

CONV = ((16, 10, 5), (16, 3, 2))
NARROW = dict(output_layer=2, num_layers=3, conv_layers=CONV, embed_dim=32,
              ffn_dim=64, pos_conv_kernel=16, pos_conv_groups=4)
JAX_NARROW = dict(NARROW, heads=2)
ATOL, RTOL = 5e-5, 1e-4


@pytest.fixture(scope="module")
def narrow():
    jax_model = J.HubertEncoder(**JAX_NARROW)
    wave = np.zeros((1, 800), np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(3), wave)["params"])
    port = C.HubertEncoder(heads=2, **NARROW).eval()
    port.load_state_dict(contentvec_params_to_state_dict(params))
    return jax_model, {"params": params}, port


def _port(model, wave, *n):
    with torch.no_grad():
        return model(torch.from_numpy(wave), *n).numpy()


@pytest.mark.parametrize("n_samples", [800, 1203])
def test_hubert_encoder_matches_jax(narrow, n_samples):
    jax_model, variables, port = narrow
    wave = np.random.default_rng(n_samples).standard_normal((2, n_samples)).astype(np.float32)
    want = np.asarray(jax_model.apply(variables, wave))
    got = _port(port, wave)
    assert got.shape == want.shape == (2, C.conv_frames(n_samples, conv_layers=CONV), 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_padded_masked_forward_matches_unpadded(narrow):
    jax_model, variables, port = narrow
    wave = np.random.default_rng(1).standard_normal((1, 800)).astype(np.float32)
    padded = np.zeros((1, 1280), np.float32)
    padded[:, :800] = wave
    n0 = C.conv_frames(800, upto=1, conv_layers=CONV)
    nf = C.conv_frames(800, conv_layers=CONV)
    ref = _port(port, wave)
    got = _port(port, padded, n0, nf)
    np.testing.assert_allclose(got[:, :nf], ref, atol=2e-5, rtol=1e-4)
    want = np.asarray(jax_model.apply(variables, padded, n0, nf))
    np.testing.assert_allclose(got[:, :nf], want[:, :nf], atol=ATOL, rtol=RTOL)
    # without the masks the padding reaches the real frames
    assert np.abs(_port(port, padded)[:, :nf] - ref).max() > 1e-4


def test_transformers_layout_matches_jax_converter():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(11)
    config = transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
        conv_dim=[c[0] for c in CONV], conv_kernel=[c[1] for c in CONV],
        conv_stride=[c[2] for c in CONV], num_feat_extract_layers=len(CONV),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        feat_extract_norm="group", do_stable_layer_norm=False, feat_extract_activation="gelu",
        hidden_act="gelu", layer_norm_eps=1e-5, hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0)
    hf = transformers.HubertModel(config).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    port = C.HubertEncoder(heads=2, **NARROW).eval()
    port.load_state_dict(C.convert_transformers_state_dict(sd, output_layer=2,
                                                           conv_layers=CONV))
    variables = J.convert_transformers_state_dict(sd, output_layer=2, conv_layers=CONV)
    wave = np.random.default_rng(2).standard_normal((1, 800)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wave), output_hidden_states=True).hidden_states[2].numpy()
    got = _port(port, wave)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(J.HubertEncoder(**JAX_NARROW).apply(
        variables, wave)), atol=ATOL, rtol=RTOL)


def fake_fairseq_state(rng, layers=2):
    """The synthetic fairseq-layout state dict of tests/test_contentvec.py,
    at full HuBERT-base width, with random norms and biases."""
    fake = {}
    cin = 1
    for i, (cout, k, _) in enumerate(C.CONV_LAYERS):
        fake[f"feature_extractor.conv_layers.{i}.0.weight"] = \
            (rng.standard_normal((cout, cin, k)) / np.sqrt(cin * k)).astype(np.float32)
        cin = cout

    def norm(name, n):
        fake[f"{name}.weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        fake[f"{name}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)

    def dense(name, n_out, n_in):
        fake[f"{name}.weight"] = (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)
                                  ).astype(np.float32)
        fake[f"{name}.bias"] = rng.normal(0, 0.1, n_out).astype(np.float32)

    norm("feature_extractor.conv_layers.0.2", 512)
    norm("layer_norm", 512)
    dense("post_extract_proj", 768, 512)
    fake["encoder.pos_conv.0.weight_g"] = rng.uniform(0.5, 1.5, (1, 1, 128)).astype(np.float32)
    fake["encoder.pos_conv.0.weight_v"] = rng.standard_normal((768, 48, 128)).astype(np.float32)
    fake["encoder.pos_conv.0.bias"] = rng.normal(0, 0.1, 768).astype(np.float32)
    norm("encoder.layer_norm", 768)
    for i in range(layers):
        t = f"encoder.layers.{i}"
        for proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.out_proj"):
            dense(f"{t}.{proj}", 768, 768)
        dense(f"{t}.fc1", 3072, 768)
        dense(f"{t}.fc2", 768, 3072)
        norm(f"{t}.self_attn_layer_norm", 768)
        norm(f"{t}.final_layer_norm", 768)
    return fake


def test_fairseq_file_through_both_encoders(tmp_path):
    """A fairseq-layout .pt with a pickled config object: both packages'
    load_fairseq_checkpoint + converter + ContentVecEncoder, 44.1 kHz in,
    units at 50 Hz out, bucketed and masked."""

    import sys
    import types

    # a class of a module absent at load time, as fairseq's config objects are
    fairseq = types.ModuleType("fairseq_config_stand_in")

    class Config:
        def __init__(self):
            self.model = {"label_rate": 50}

    Config.__module__, Config.__qualname__ = fairseq.__name__, "Config"
    fairseq.Config = Config
    rng = np.random.default_rng(7)
    state = fake_fairseq_state(rng)
    sys.modules[fairseq.__name__] = fairseq
    try:
        torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()},
                    "cfg": Config()}, tmp_path / "checkpoint.pt")
    finally:
        del sys.modules[fairseq.__name__]
    port_state = C.load_fairseq_checkpoint(tmp_path / "checkpoint.pt")
    assert port_state.keys() == J.load_fairseq_checkpoint(tmp_path / "checkpoint.pt").keys()
    port = C.ContentVecEncoder(tmp_path / "checkpoint.pt", output_layer=2, device="cpu")
    jax_encoder = J.ContentVecEncoder(tmp_path / "checkpoint.pt", output_layer=2)
    t = np.arange(int(44100 * 0.7)) / 44100
    wave = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.standard_normal(len(t))
            ).astype(np.float32)
    got, want = port(wave, sample_rate=44100), jax_encoder(wave, sample_rate=44100)
    assert got.shape == want.shape == (C.conv_frames(int(len(wave) * 16000 / 44100)), 768)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert port(wave[:100], sample_rate=44100).shape == (0, 768)


def test_buckets_and_missing_checkpoint():
    for n in (1, 16000, 16001, 10 * 60 * 16000):
        assert C._sample_bucket(n) == J._sample_bucket(n)
        assert C.conv_frames(n) == J.conv_frames(n)
    with pytest.raises(FileNotFoundError):
        C.ContentVecEncoder.cached("/nonexistent/checkpoint.pt", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            C.ContentVecEncoder(None)
