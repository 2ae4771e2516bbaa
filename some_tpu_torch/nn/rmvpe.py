"""RMVPE vocal pitch estimator as torch modules.

Port of ``some_tpu/nn/rmvpe.py``. ``E2E0`` keeps the reference's module tree
and key names (reference: modules/rmvpe/model.py, deepunet.py, seq.py): a
5-level residual-conv U-Net over [B, 1, T, 128-mel] (avg-pool down,
transposed-conv up) -> 3-channel conv -> 1-layer BiGRU (256 each way) ->
Linear -> sigmoid over 360 20-cent pitch classes. The published
``model.pt`` loads with ``load_state_dict`` (``load_rmvpe_state_dict``
drops the TimbreFilter parameters, which the reference's forward never
calls, and is otherwise strict).

Bucket padding is invisible to real frames, as in the JAX package: with
per-row ``t_valid`` (each row's pad-to-32 length) every point where JAX
re-zeroes frames at or past ``t_valid >> level`` re-zeroes them here
(eval-mode BatchNorm maps a zero to a constant, which the next 3x3 conv
would carry into real frames), and the BiGRU runs packed sequences of the
rows' lengths, so the reverse direction starts at each row's own last
valid frame. The forwards pin true f32 (no TF32 in cuDNN's convolutions and
RNN or in cuBLAS), whatever the process set.

The wrapper ``RMVPE`` (reference: modules/rmvpe/inference.py:13-66) runs on
the card unless given ``device="cpu"``: the host log-mel (16 kHz, 128 mels,
win 1024, hop 160, fmin 30, fmax 8000), padding to a frame bucket, the
forward, the local-average (or Viterbi) decode to f0, unvoiced
interpolation, the curve resampled to the caller's hop grid.
"""
from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np
import torch
from torch import nn

from some_tpu_torch.ops.melspec import full_f32

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30
MEL_FMAX = 8000
WINDOW_LENGTH = 1024
HOP_LENGTH = 160
CENTS_CONST = 1997.3794084376191


# ---------------------------------------------------------------- modules
def _mask_time(x: torch.Tensor, t_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero every frame of [B, C, T, M] at time index >= t_valid[b] (per row)."""
    if t_valid is None:
        return x
    keep = torch.arange(x.shape[2], device=x.device)[None, :] < t_valid[:, None]
    return x.masked_fill(~keep[:, None, :, None], 0)


class ConvBlockRes(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, momentum: float = 0.01):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum),
            nn.ReLU(),
        )
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x, t_valid=None):
        h = _mask_time(self.conv[2](self.conv[1](self.conv[0](x))), t_valid)
        h = self.conv[5](self.conv[4](self.conv[3](h)))
        return _mask_time(h + (x if self.shortcut is None else self.shortcut(x)), t_valid)


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_blocks: int, pool: bool):
        super().__init__()
        self.conv = nn.ModuleList([ConvBlockRes(in_channels, out_channels)] + [
            ConvBlockRes(out_channels, out_channels) for _ in range(n_blocks - 1)])
        # t_valid is a multiple of 32 >= 2**levels, so a pool window never
        # straddles the valid/pad boundary at any level
        self.pool = nn.AvgPool2d(2) if pool else None

    def forward(self, x, t_valid=None):
        for block in self.conv:
            x = block(x, t_valid)
        return x if self.pool is None else (x, self.pool(x))


class ResDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_blocks: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=0.01),
            nn.ReLU(),
        )
        self.conv2 = nn.ModuleList([ConvBlockRes(out_channels * 2, out_channels)] + [
            ConvBlockRes(out_channels, out_channels) for _ in range(n_blocks - 1)])

    def forward(self, x, skip, t_valid=None):
        # t_valid here is the output level's valid length (2x the input's)
        x = torch.cat((_mask_time(self.conv1(x), t_valid), skip), dim=1)
        for block in self.conv2:
            x = block(x, t_valid)
        return x


class Encoder(nn.Module):
    def __init__(self, layers: int, n_blocks: int, out_channels: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(1, momentum=0.01)
        self.layers = nn.ModuleList()
        in_channels = 1
        for _ in range(layers):
            self.layers.append(ResEncoderBlock(in_channels, out_channels, n_blocks, pool=True))
            in_channels, out_channels = out_channels, out_channels * 2


class Intermediate(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int, n_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [ResEncoderBlock(in_channels, out_channels, n_blocks, pool=False)]
            + [ResEncoderBlock(out_channels, out_channels, n_blocks, pool=False)
               for _ in range(layers - 1)])


class Decoder(nn.Module):
    def __init__(self, in_channels: int, layers: int, n_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(layers):
            self.layers.append(ResDecoderBlock(in_channels, in_channels // 2, n_blocks))
            in_channels //= 2


class DeepUnet0(nn.Module):
    def __init__(self, n_blocks: int, en_de_layers: int = 5, inter_layers: int = 4,
                 en_out_channels: int = 16):
        super().__init__()
        deep = en_out_channels << en_de_layers
        self.encoder = Encoder(en_de_layers, n_blocks, en_out_channels)
        self.intermediate = Intermediate(deep // 2, deep, inter_layers, n_blocks)
        self.decoder = Decoder(deep, en_de_layers, n_blocks)

    def forward(self, x, t_valid=None):
        def tv(level):  # valid frames at downsampling level
            return None if t_valid is None else t_valid >> level

        x = _mask_time(self.encoder.bn(x), t_valid)
        skips = []
        for i, layer in enumerate(self.encoder.layers):
            skip, x = layer(x, tv(i))
            skips.append(skip)
        deep = len(skips)
        for layer in self.intermediate.layers:
            x = layer(x, tv(deep))
        for i, layer in enumerate(self.decoder.layers):
            x = layer(x, skips[-1 - i], tv(deep - 1 - i))
        return x


class BiGRU(nn.Module):
    def __init__(self, input_features: int, hidden_features: int, num_layers: int):
        super().__init__()
        self.gru = nn.GRU(input_features, hidden_features, num_layers=num_layers,
                          batch_first=True, bidirectional=True)

    def forward(self, x, lengths=None):
        """[B, T, C] -> [B, T, 2H]; with ``lengths`` [B], each row's steps
        past its length enter neither direction (their outputs are zero)."""
        if lengths is None:
            return self.gru(x)[0]
        packed = nn.utils.rnn.pack_padded_sequence(
            x, lengths.cpu(), batch_first=True, enforce_sorted=False)
        out, _ = self.gru(packed)
        return nn.utils.rnn.pad_packed_sequence(out, batch_first=True,
                                                total_length=x.shape[1])[0]


class E2E0(nn.Module):
    """mel [B, T, 128] -> pitch-class probabilities [B, T, 360]."""

    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5, inter_layers: int = 4,
                 en_out_channels: int = 16, n_mels: int = N_MELS):
        super().__init__()
        self.unet = DeepUnet0(n_blocks, en_de_layers, inter_layers, en_out_channels)
        self.cnn = nn.Conv2d(en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(BiGRU(3 * n_mels, 256, 1), nn.Linear(512, N_CLASS),
                                nn.Dropout(0.25), nn.Sigmoid())

    def forward(self, mel: torch.Tensor, t_valid=None) -> torch.Tensor:
        """``t_valid``: each row's semantic (pad-to-32) length, an int or [B];
        frames past it are invisible to the rest (inference only: masked
        zeros would enter BatchNorm's batch statistics in training)."""
        if t_valid is not None:
            if self.training:
                raise ValueError("t_valid masking is inference-only: masked "
                                 "zeros would pollute BatchNorm batch stats")
            t_valid = torch.as_tensor(t_valid, dtype=torch.int64, device=mel.device)
            t_valid = t_valid.expand(mel.shape[0]) if t_valid.dim() == 0 else t_valid
        with full_f32():
            x = self.unet(mel.unsqueeze(1), t_valid)
            # [B, 3, T, M] -> [B, T, 3 * M]
            x = self.cnn(x).transpose(1, 2).flatten(-2)
            return torch.sigmoid(self.fc[1](self.fc[0](x, t_valid)))


def load_rmvpe_state_dict(model: E2E0, state: dict) -> None:
    """The reference's state dict -> ``model``: the TimbreFilter parameters
    (``unet.tf.*``) are dropped, as the JAX converter drops them; every
    other key must match."""
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()
                           if not k.startswith("unet.tf.")}, strict=True)


def random_state_dict(seed: int = 0, **geometry) -> dict:
    """A seeded random E2E0 state dict in the upstream ``model.pt`` layout,
    TimbreFilter parameters included, with BatchNorm running statistics
    drawn at random so the output is not flat (tests/test_rmvpe.py's
    oracle does the same)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = E2E0(**geometry)
        channels = [block.conv[0].conv[3].out_channels for block in model.unet.encoder.layers]
        tf = nn.ModuleList([ConvBlockRes(c, c) for c in channels])
    state = model.state_dict()
    state.update({f"unet.tf.layers.{k}": v for k, v in tf.state_dict().items()})
    for key, value in state.items():
        if key.endswith("running_mean"):
            value.normal_(0, 0.3, generator=gen)
        elif key.endswith("running_var"):
            value.uniform_(0.5, 2.0, generator=gen)
    return state


# ---------------------------------------------------------------- decode
def _argmax_window(hidden: torch.Tensor):
    """[B, T, 360] probabilities -> (center [B, T], window [B, T, 9]): the
    only values local_average_cents reads, on the device, so only they are
    copied to the host. Bit-exact: scattering the window back into zeros
    rebuilds every value the decode's mask can select."""
    center = torch.argmax(hidden, dim=2)
    idx = (center[..., None] + torch.arange(-4, 5, device=hidden.device)).clamp(0, N_CLASS - 1)
    return center.to(torch.int32), torch.gather(hidden, 2, idx)


def _decode_window(center: np.ndarray, window: np.ndarray,
                   thred: float = 0.03) -> np.ndarray:
    """Host half of the window fetch: rebuild the sparse probability array
    and run the unmodified decode on it (same sums, same argmax, same uv
    threshold — see _argmax_window)."""
    center = np.asarray(center)
    window = np.asarray(window)
    sparse = np.zeros(center.shape + (N_CLASS,), np.float32)
    idx = np.clip(center[..., None] + np.arange(-4, 5), 0, N_CLASS - 1)
    np.put_along_axis(sparse, idx, window, axis=2)
    return local_average_cents(sparse, center=center[..., None], thred=thred)


def local_average_cents(hidden: np.ndarray, center: Optional[np.ndarray] = None,
                        thred: float = 0.03) -> np.ndarray:
    """Prob-weighted average over argmax+-4 bins -> f0 Hz, unvoiced -> 0
    (reference: modules/rmvpe/utils.py:8-24)."""
    hidden = np.asarray(hidden)
    idx = np.arange(N_CLASS)[None, None, :]
    idx_cents = idx * 20 + CENTS_CONST
    if center is None:
        center = np.argmax(hidden, axis=2, keepdims=True)
    start = np.clip(center - 4, 0, None)
    end = np.clip(center + 5, None, N_CLASS)
    mask = (idx >= start) & (idx < end)
    weights = hidden * mask
    product_sum = np.sum(weights * idx_cents, axis=2)
    weight_sum = np.sum(weights, axis=2)
    cents = product_sum / (weight_sum + (weight_sum == 0))
    f0 = 10 * 2 ** (cents / 1200)
    uv = hidden.max(axis=2) < thred
    return (f0 * ~uv).squeeze(0)


def viterbi_cents(hidden: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """Viterbi-smoothed decode (reference: modules/rmvpe/utils.py:27-43),
    with a self-contained numpy Viterbi replacing librosa.sequence.viterbi."""
    xx, yy = np.meshgrid(range(N_CLASS), range(N_CLASS))
    transition = np.maximum(30 - abs(xx - yy), 0).astype(np.float64)
    transition = transition / transition.sum(axis=1, keepdims=True)

    prob = np.asarray(hidden, dtype=np.float64).squeeze(0).T  # [N, T]
    prob = prob / prob.sum(axis=0, keepdims=True)

    log_trans = np.log(transition + 1e-300)
    log_prob = np.log(prob + 1e-300)
    T = log_prob.shape[1]
    value = log_prob[:, 0] + np.log(1.0 / N_CLASS)
    back = np.zeros((T, N_CLASS), dtype=np.int64)
    for t in range(1, T):
        scores = value[:, None] + log_trans  # [from, to]
        back[t] = scores.argmax(axis=0)
        value = scores.max(axis=0) + log_prob[:, t]
    path = np.zeros(T, dtype=np.int64)
    path[-1] = value.argmax()
    for t in range(T - 2, -1, -1):
        path[t] = back[t + 1, path[t + 1]]
    center = path[None, :, None]
    return local_average_cents(hidden, center=center, thred=thred)


# ---------------------------------------------------------------- wrapper
def _bucket_frames(sem: int) -> int:
    """Snap a semantic (pad-to-32) frame count to a geometric bucket:
    ratio-4/3 buckets snapped to multiples of 32, about 16 shapes across
    5 s .. 3.5 min songs, so cuDNN meets few shapes (each new one is
    autotuned on first use); the masked forward makes the result
    independent of how far the bucket extends past the semantic length."""
    b = 512
    while b < sem:
        b = -(-b * 4 // 3)           # ceil(b * 4/3)
        b = ((b + 31) // 32) * 32
    return b


class RMVPE:
    """Pitch extraction with E2E0 on ``device`` (the card unless ``"cpu"``).

    ``model_path``: the reference's ``model.pt`` (loaded with pickle, so
    only files you trust), or None for random weights (seed 0; tests)."""

    _cache: dict = {}

    def __init__(self, model_path: pathlib.Path | str | None, hop_length: int = HOP_LENGTH,
                 bucket: bool = True, device=None):
        from some_tpu_torch.audio.mel import MelSpec
        from some_tpu_torch.inference.base_infer import resolve_device

        self.device = resolve_device(device)
        self.model = E2E0()
        if model_path is not None:
            ckpt = torch.load(str(model_path), map_location="cpu", weights_only=False)
            load_rmvpe_state_dict(self.model, ckpt.get("model", ckpt))
        else:
            load_rmvpe_state_dict(self.model, random_state_dict(0))
        self.model.to(self.device).eval()
        self.hop_length = hop_length
        self.mel = MelSpec(N_MELS, SAMPLE_RATE, WINDOW_LENGTH, hop_length,
                           fmin=MEL_FMIN, fmax=MEL_FMAX)
        self.bucket = bucket

    @classmethod
    def cached(cls, model_path, device=None) -> "RMVPE":
        """One instance per (checkpoint, device); FileNotFoundError when no
        checkpoint is configured or the file is missing."""
        from some_tpu_torch.inference.base_infer import resolve_device

        if model_path is None:
            raise FileNotFoundError("no RMVPE checkpoint configured (pe_ckpt)")
        key = (str(model_path), str(resolve_device(device)))
        if key not in cls._cache:
            if not pathlib.Path(model_path).exists():
                raise FileNotFoundError(model_path)
            cls._cache[key] = cls(model_path, device=device)
        return cls._cache[key]

    @torch.no_grad()
    def _forward(self, mel: np.ndarray, t_valid) -> torch.Tensor:
        return self.model(torch.from_numpy(mel).to(self.device),
                          t_valid=torch.as_tensor(t_valid, dtype=torch.int64))

    @torch.no_grad()
    def _forward_window(self, mel: np.ndarray, t_valid):
        center, window = _argmax_window(self._forward(mel, t_valid))
        return center.cpu().numpy(), window.cpu().numpy()

    def mel2hidden(self, mel: np.ndarray) -> np.ndarray:
        """mel [T, 128] -> probabilities [1, T, 360], as the reference's
        pad-T-to-a-multiple-of-32 forward: the input is padded to a frame
        bucket and t_valid hides everything past the pad-32 length."""
        n_frames = mel.shape[0]
        sem = 32 * ((n_frames - 1) // 32 + 1)
        total = _bucket_frames(sem) if self.bucket else sem
        mel = np.pad(mel, ((0, total - n_frames), (0, 0)))
        return self._forward(mel[None], [sem]).cpu().numpy()[:, :n_frames]

    def mel2hidden_batch(self, mels) -> list:
        """Many items' mels -> list of [1, T_i, 360], packed into batches of
        up to 8 rows (``_packed_chunks``); each item's numbers are
        mel2hidden's, since t_valid is per row."""
        results: list = [None] * len(mels)
        for chunk, batch, t_valid in self._packed_chunks(mels):
            hidden = self._forward(batch, t_valid).cpu().numpy()
            for r, i in enumerate(chunk):
                results[i] = hidden[r:r + 1, :mels[i].shape[0]]
        return results

    def _packed_chunks(self, mels):
        """Yield (item_indices, mel_batch, t_valid): items sorted by length,
        8 rows at most, each chunk padded to the bucket of its longest
        member, rows snapped to 1/2/4/8 (dummy rows get t_valid 32)."""
        order = sorted(range(len(mels)), key=lambda i: -mels[i].shape[0])
        for pos in range(0, len(order), 8):
            chunk = order[pos:pos + 8]
            sems = [32 * ((mels[i].shape[0] - 1) // 32 + 1) for i in chunk]
            total = _bucket_frames(max(sems)) if self.bucket else max(sems)
            rows = 1 << max(0, (len(chunk) - 1).bit_length())  # 1/2/4/8
            batch = np.zeros((rows, total, N_MELS), np.float32)
            t_valid = np.full((rows,), 32, np.int64)
            for r, (i, sem) in enumerate(zip(chunk, sems)):
                batch[r, :mels[i].shape[0]] = mels[i]
                t_valid[r] = sem
            yield chunk, batch, t_valid

    def audio_to_mel(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """Resample to RMVPE's native 16 kHz and compute its log-mel."""
        from some_tpu_torch.audio.wavio import resample

        if sample_rate != SAMPLE_RATE:
            audio = resample(audio, sample_rate, SAMPLE_RATE)
        return self.mel(audio)  # [T, 128]

    def f0_batch(self, waveforms, sample_rate: int, thred: float = 0.03) -> list:
        """Many waveforms -> list of 10 ms f0 curves: the forwards packed
        (``_packed_chunks``), only the decode window copied to the host.
        Finish per item with f0_to_grid."""
        mels = [self.audio_to_mel(w, sample_rate) for w in waveforms]
        results: list = [None] * len(mels)
        for chunk, batch, t_valid in self._packed_chunks(mels):
            center, window = self._forward_window(batch, t_valid)
            for r, i in enumerate(chunk):
                n = mels[i].shape[0]
                results[i] = _decode_window(center[r:r + 1, :n], window[r:r + 1, :n],
                                            thred=thred)
        return results

    def infer_from_audio(self, audio: np.ndarray, sample_rate: int = 16000,
                         thred: float = 0.03, use_viterbi: bool = False) -> np.ndarray:
        hidden = self.mel2hidden(self.audio_to_mel(audio, sample_rate))
        if use_viterbi:
            return viterbi_cents(hidden, thred=thred)
        return local_average_cents(hidden, thred=thred)

    @staticmethod
    def f0_to_grid(f0: np.ndarray, sample_rate: int, hop_size: int,
                   length: int, interp_uv: bool = False):
        """RMVPE's native 10 ms f0 curve -> the caller's hop grid
        (the tail of reference rmvpe/inference.py:56-66)."""
        from some_tpu_torch.utils.pitch import interp_f0, resample_align_curve

        uv = f0 == 0
        f0, uv = interp_f0(f0, uv)
        time_step = hop_size / sample_rate
        f0_res = resample_align_curve(f0, 0.01, time_step, length)
        uv_res = resample_align_curve(uv.astype(np.float32), 0.01, time_step,
                                      length) > 0.5
        if not interp_uv:
            f0_res[uv_res] = 0
        return f0_res, uv_res

    def get_pitch(self, waveform: np.ndarray, sample_rate: int, hop_size: int,
                  length: int, interp_uv: bool = False):
        """f0 on the caller's hop grid (reference: rmvpe/inference.py:56-66)."""
        f0 = self.infer_from_audio(waveform, sample_rate=sample_rate)
        return self.f0_to_grid(f0, sample_rate, hop_size, length, interp_uv=interp_uv)
