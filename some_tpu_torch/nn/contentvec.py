"""ContentVec / HuBERT-base units encoder as torch modules.

Port of ``some_tpu/nn/contentvec.py``. The reference wraps a fairseq HuBERT
ensemble and takes layer-9 features (reference:
modules/contentvec/__init__.py:5-24); here the forward is native:

  waveform 16 kHz -> 7-layer strided conv feature extractor (512 ch,
  GroupNorm on the first layer, exact GELU) -> feature LayerNorm ->
  512->768 projection -> +relative positional conv (kernel 128, 16 groups,
  SamePad trim) -> encoder LayerNorm (post-norm architecture) -> N
  post-norm transformer layers -> features after ``output_layer`` layers.

The modules are named after the JAX package's variable tree (``layers.{i}``
for its ``layer_{i}``), in torch's layouts. Attention is an einsum and a
softmax, as in the JAX package, which runs it outside any Pallas kernel.
The forward pins true f32 (no TF32 in cuBLAS or cuDNN), whatever the
process set.

Checkpoints: ``load_fairseq_checkpoint`` unpickles the published fairseq
.pt with fairseq's classes stubbed, and ``convert_fairseq_state_dict`` maps
its weights; ``convert_transformers_state_dict`` maps a Hugging Face
HubertModel state dict.
"""
from __future__ import annotations

import pathlib
import pickle
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from some_tpu_torch.ops.melspec import full_f32

# HuBERT-base geometry
CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 3, 2), (512, 2, 2), (512, 2, 2),
)  # (dim, kernel, stride)
EMBED_DIM = 768
NUM_LAYERS = 12
NUM_HEADS = 12
FFN_DIM = 3072
POS_CONV_KERNEL = 128
POS_CONV_GROUPS = 16


class _MaskedGroupNorm(nn.Module):
    """GroupNorm with one group per channel (statistics over time, torch's
    GroupNorm(512, 512) on [B, C, T]) that can leave padded tail frames out
    of the statistics, so zero-padding the waveform changes nothing for
    real frames."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x, n_real=None):  # x: [B, C, T]
        w = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        if n_real is not None:
            w = (torch.arange(x.shape[-1], device=x.device) < n_real).to(x.dtype)
        denom = w.sum().clamp(min=1.0)
        mean = (x * w).sum(-1, keepdim=True) / denom
        var = (torch.square(x - mean) * w).sum(-1, keepdim=True) / denom
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight[:, None]
                + self.bias[:, None])


class FeatureExtractor(nn.Module):
    """[B, S] waveform -> [B, T, 512].

    ``n_real0``: the number of real frames after conv_0 when the waveform is
    zero-padded to a bucket; only the GroupNorm statistics need it (every
    later valid conv's real output frame reads only real input frames)."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = CONV_LAYERS):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        cin = 1
        for dim, kernel, stride in conv_layers:
            self.conv_layers.append(nn.Conv1d(cin, dim, kernel, stride=stride, bias=False))
            cin = dim
        self.group_norm = _MaskedGroupNorm(conv_layers[0][0])

    def forward(self, x, n_real0=None):
        x = x[:, None, :]
        for i, conv in enumerate(self.conv_layers):
            x = conv(x)
            if i == 0:
                x = self.group_norm(x, n_real0)
            x = F.gelu(x)
        return x.transpose(1, 2)


class TransformerLayer(nn.Module):
    """Post-norm encoder layer (fairseq layer_norm_first=False)."""

    def __init__(self, dim: int = EMBED_DIM, heads: int = NUM_HEADS, ffn_dim: int = FFN_DIM):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.attn_norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, key_mask=None):
        B, T, dim = x.shape
        head_dim = dim // self.heads
        q = (self.q_proj(x) * head_dim ** -0.5).view(B, T, self.heads, head_dim)
        k = self.k_proj(x).view(B, T, self.heads, head_dim)
        v = self.v_proj(x).view(B, T, self.heads, head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_mask is not None:  # [B, T] True on real frames
            scores = scores.masked_fill(~key_mask[:, None, None, :], -1e9)
        att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        x = self.attn_norm(x + self.out_proj(att.reshape(B, T, dim)))
        return self.final_norm(x + self.fc2(F.gelu(self.fc1(x))))


class HubertEncoder(nn.Module):
    """The units encoder; returns features after ``output_layer`` layers."""

    def __init__(self, output_layer: int = 9, num_layers: int = NUM_LAYERS,
                 conv_layers: Sequence[Tuple[int, int, int]] = CONV_LAYERS,
                 embed_dim: int = EMBED_DIM, heads: int = NUM_HEADS, ffn_dim: int = FFN_DIM,
                 pos_conv_kernel: int = POS_CONV_KERNEL, pos_conv_groups: int = POS_CONV_GROUPS):
        super().__init__()
        self.feature_extractor = FeatureExtractor(conv_layers)
        self.feature_norm = nn.LayerNorm(conv_layers[-1][0], eps=1e-5)
        self.post_proj = nn.Linear(conv_layers[-1][0], embed_dim)
        self.pos_conv = nn.Conv1d(embed_dim, embed_dim, pos_conv_kernel,
                                  padding=pos_conv_kernel // 2, groups=pos_conv_groups)
        self.encoder_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.layers = nn.ModuleList(TransformerLayer(embed_dim, heads, ffn_dim)
                                    for _ in range(min(output_layer, num_layers)))

    def forward(self, waveform, n_real0=None, n_real=None):
        """``n_real0``/``n_real``: real frame counts after conv_0 / at the
        encoder grid when ``waveform`` is zero-padded to a bucket. With both
        given, real-frame outputs are the unpadded forward's (masked
        GroupNorm statistics, padded frames zeroed before the positional
        conv, masked attention keys); padded tail frames are garbage the
        caller crops."""
        with full_f32():
            x = self.post_proj(self.feature_norm(self.feature_extractor(waveform, n_real0)))
            frame_mask = None
            if n_real is not None:
                frame_mask = (torch.arange(x.shape[1], device=x.device) < n_real)
                frame_mask = frame_mask[None].expand(x.shape[0], -1)
                # padded frames zeroed, so the positional conv sees exactly
                # the implicit zeros of an unpadded forward
                x = x.masked_fill(~frame_mask[..., None], 0)
            pos = self.pos_conv(x.transpose(1, 2))
            if self.pos_conv.kernel_size[0] % 2 == 0:
                pos = pos[..., :-1]  # SamePad trim for an even kernel
            x = self.encoder_norm(x + F.gelu(pos).transpose(1, 2))
            for layer in self.layers:
                x = layer(x, frame_mask)
            return x


# ------------------------------------------------------------- converters
def _fold_weight_norm(weight_g, weight_v):
    """torch weight_norm(conv, dim=2): w = g * v / ||v||_dims(0,1)."""
    norm = np.linalg.norm(weight_v, axis=(0, 1), keepdims=True)
    return weight_g * weight_v / norm


def _layer_state(sd: dict, output_layer: int, src: str, names: dict) -> dict:
    """Per-layer weights of ``sd`` under ``src.{i}.<name>`` -> ``layers.{i}.<port name>``."""
    out = {}
    for i in range(output_layer):
        for name, port in names.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{port}.{leaf}"] = sd[f"{src}.{i}.{name}.{leaf}"]
    return out


def _to_state(out: dict) -> dict:
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in out.items()}


def convert_fairseq_state_dict(sd: dict, output_layer: int = 9,
                               conv_layers=CONV_LAYERS) -> dict:
    """fairseq HubertModel state dict -> the port's HubertEncoder state dict."""
    out = {f"feature_extractor.conv_layers.{i}.weight":
           sd[f"feature_extractor.conv_layers.{i}.0.weight"] for i in range(len(conv_layers))}
    out.update({
        "feature_extractor.group_norm.weight": sd["feature_extractor.conv_layers.0.2.weight"],
        "feature_extractor.group_norm.bias": sd["feature_extractor.conv_layers.0.2.bias"],
        "feature_norm.weight": sd["layer_norm.weight"],
        "feature_norm.bias": sd["layer_norm.bias"],
        "post_proj.weight": sd["post_extract_proj.weight"],
        "post_proj.bias": sd["post_extract_proj.bias"],
        "pos_conv.weight": _fold_weight_norm(
            np.asarray(sd["encoder.pos_conv.0.weight_g"], np.float32),
            np.asarray(sd["encoder.pos_conv.0.weight_v"], np.float32)),
        "pos_conv.bias": sd["encoder.pos_conv.0.bias"],
        "encoder_norm.weight": sd["encoder.layer_norm.weight"],
        "encoder_norm.bias": sd["encoder.layer_norm.bias"],
    })
    out.update(_layer_state(sd, output_layer, "encoder.layers", {
        "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
        "self_attn.v_proj": "v_proj", "self_attn.out_proj": "out_proj",
        "self_attn_layer_norm": "attn_norm", "fc1": "fc1", "fc2": "fc2",
        "final_layer_norm": "final_norm"}))
    return _to_state(out)


def convert_transformers_state_dict(sd: dict, output_layer: int = 9,
                                    conv_layers=CONV_LAYERS) -> dict:
    """Hugging Face HubertModel state dict -> the port's HubertEncoder state dict."""
    out = {f"feature_extractor.conv_layers.{i}.weight":
           sd[f"feature_extractor.conv_layers.{i}.conv.weight"] for i in range(len(conv_layers))}
    if "encoder.pos_conv_embed.conv.weight_g" in sd:
        wg = sd["encoder.pos_conv_embed.conv.weight_g"]
        wv = sd["encoder.pos_conv_embed.conv.weight_v"]
    else:  # torch >= 2.1 parametrized weight norm
        wg = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"]
        wv = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"]
    out.update({
        "feature_extractor.group_norm.weight":
            sd["feature_extractor.conv_layers.0.layer_norm.weight"],
        "feature_extractor.group_norm.bias": sd["feature_extractor.conv_layers.0.layer_norm.bias"],
        "feature_norm.weight": sd["feature_projection.layer_norm.weight"],
        "feature_norm.bias": sd["feature_projection.layer_norm.bias"],
        "post_proj.weight": sd["feature_projection.projection.weight"],
        "post_proj.bias": sd["feature_projection.projection.bias"],
        "pos_conv.weight": _fold_weight_norm(np.asarray(wg, np.float32),
                                             np.asarray(wv, np.float32)),
        "pos_conv.bias": sd["encoder.pos_conv_embed.conv.bias"],
        "encoder_norm.weight": sd["encoder.layer_norm.weight"],
        "encoder_norm.bias": sd["encoder.layer_norm.bias"],
    })
    out.update(_layer_state(sd, output_layer, "encoder.layers", {
        "attention.q_proj": "q_proj", "attention.k_proj": "k_proj",
        "attention.v_proj": "v_proj", "attention.out_proj": "out_proj",
        "layer_norm": "attn_norm", "feed_forward.intermediate_dense": "fc1",
        "feed_forward.output_dense": "fc2", "final_layer_norm": "final_norm"}))
    return _to_state(out)


class _StubUnpickler(pickle.Unpickler):
    """Unpickler that stubs classes from packages absent here (fairseq
    config dataclasses, omegaconf containers)."""

    class _Stub:
        def __init__(self, *args, **kwargs):
            self.__dict__.update(kwargs)

        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (self._Stub,), {"__module__": module})


class _PickleShim:
    """pickle-module shim handing torch the tolerant Unpickler."""
    Unpickler = _StubUnpickler
    load = staticmethod(pickle.load)
    dumps = staticmethod(pickle.dumps)
    loads = staticmethod(pickle.loads)
    HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL


def load_fairseq_checkpoint(path: pathlib.Path | str) -> dict:
    """The raw weight tensors of a fairseq .pt, without fairseq (pickle:
    only files you trust)."""
    with open(path, "rb") as f:
        try:
            ckpt = torch.load(f, map_location="cpu", weights_only=False,
                              pickle_module=_PickleShim)
        except Exception:
            f.seek(0)
            ckpt = torch.load(f, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt.get("state_dict", ckpt))
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in state.items() if hasattr(v, "detach")}


def conv_frames(n_samples: int, upto: int | None = None,
                conv_layers=CONV_LAYERS) -> int:
    """Output frame count of the first ``upto`` valid conv layers."""
    for dim, kernel, stride in conv_layers[:upto]:
        n_samples = (n_samples - kernel) // stride + 1
    return n_samples


def _sample_bucket(n: int, start: int = 16000) -> int:
    """Geometric (x1.5) sample-count bucket: a handful of shapes across a
    dataset of arbitrary song lengths."""
    b = start
    while b < n:
        b = b * 3 // 2
    return b


class ContentVecEncoder:
    """The reference's ContentVec768L12 units encoder on ``device`` (the
    card unless ``"cpu"``).

    Waveforms are zero-padded to geometric sample buckets; the masked
    GroupNorm, positional conv and attention make the padded forward equal
    to the unpadded one on real frames (see HubertEncoder). ``ckpt_path``
    None gives seeded random weights (tests, the chip smoke test)."""

    _cache: dict = {}

    def __init__(self, ckpt_path: pathlib.Path | str | None, output_layer: int = 9,
                 device=None, seed: int = 0):
        from some_tpu_torch.inference.base_infer import resolve_device

        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = HubertEncoder(output_layer=output_layer)
        if ckpt_path is not None:
            self.model.load_state_dict(convert_fairseq_state_dict(
                load_fairseq_checkpoint(ckpt_path), output_layer=output_layer))
        self.model.to(self.device).eval()

    @classmethod
    def cached(cls, ckpt_path, device=None) -> "ContentVecEncoder":
        from some_tpu_torch.inference.base_infer import resolve_device

        key = (str(ckpt_path), str(resolve_device(device)))
        if key not in cls._cache:
            if ckpt_path is None or not pathlib.Path(ckpt_path).exists():
                raise FileNotFoundError(f"contentvec checkpoint not found: {ckpt_path}")
            cls._cache[key] = cls(ckpt_path, device=device)
        return cls._cache[key]

    @torch.no_grad()
    def __call__(self, waveform: np.ndarray, sample_rate: int = 44100) -> np.ndarray:
        """[S] waveform -> [T, 768] units at the encoder's 50 Hz grid."""
        from some_tpu_torch.audio.wavio import resample

        if sample_rate != 16000:
            waveform = resample(waveform, sample_rate, 16000)
        waveform = np.asarray(waveform, np.float32)
        n = len(waveform)
        n_real = max(conv_frames(n), 0)
        if n_real == 0:  # shorter than the conv stack's receptive field
            return np.zeros((0, self.model.encoder_norm.normalized_shape[0]), np.float32)
        padded = np.zeros(_sample_bucket(n), np.float32)
        padded[:n] = waveform
        out = self.model(torch.from_numpy(padded[None]).to(self.device),
                         max(conv_frames(n, upto=1), 0), n_real)
        return out[0, :n_real].cpu().numpy()
