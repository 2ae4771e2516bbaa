"""The port's audio wires and half-rate wire against the JAX package's, on
the same numpy inputs: encode (host, numpy), decode (device, torch on the
CPU), the silence buffers, the decimation of the half-rate wire, and the
log-mel of the decimated audio with its magnitude scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from some_tpu.audio import wire as jax_wire
from some_tpu.audio.wavio import decimate_wire as jax_decimate_wire
from some_tpu.audio.wavio import wire_decimation_taps as jax_taps
from some_tpu.native import get_lib as jax_native_lib
from some_tpu.ops.melspec import LogMelSpec as JaxLogMelSpec
from some_tpu_torch.audio import wire
from some_tpu_torch.audio.wavio import decimate_wire, wire_decimation_taps
from some_tpu_torch.ops.melspec import LogMelSpec

SR = 44100
WIRES = ("int16", "float32", "mulaw8", "mulaw12")
# XLA's f32 expm1 rounds otherwise than torch's, and under jit XLA fuses
# mulaw8's scale and offset and turns the division by mu into a product with
# its reciprocal: eager and jitted JAX themselves differ by up to 11 f32 ulp
# on the mulaw8 codes (1 on mulaw12's). Over every code the port sits within
# 3 ulp (mulaw8) and 4 (mulaw12) of eager JAX and 10 and 3 of jitted JAX; it
# is held to 4 ulp of eager JAX and 16 of jitted (+ 2^-24 near zero).
EAGER_ULPS, JIT_ULPS = 4, 16


def _wave(shape, seed):
    rng = np.random.default_rng(seed)
    # past full scale on purpose: every wire clips
    return np.clip(rng.standard_normal(shape) * 0.5, -1.2, 1.2).astype(np.float32)


def _within_ulps(got: np.ndarray, want: np.ndarray, ulps: int) -> bool:
    return bool((np.abs(got - want) <= ulps * np.spacing(np.abs(want)) + 2.0 ** -24).all())


@pytest.mark.parametrize("name", WIRES)
@pytest.mark.parametrize("shape", [(1001,), (2, 1000), (3, 777)])
def test_encode_matches_jax_bit_for_bit(name, shape):
    wave = _wave(shape, sum(shape))
    got = wire.encode_wire(wave, name)
    want = jax_wire.encode_wire(wave, name)
    assert got.dtype == want.dtype == wire.wire_np_dtype(name)
    np.testing.assert_array_equal(got, want)
    assert got.shape[-1] == wire.wire_width(name, shape[-1]) == jax_wire.wire_width(name, shape[-1])
    np.testing.assert_array_equal(wire.silence_buffer(name, 3, shape[-1]),
                                  jax_wire.silence_buffer(name, 3, shape[-1]))
    if name != "mulaw12":
        assert wire.wire_zero(name) == jax_wire.wire_zero(name)


@pytest.mark.parametrize("name", WIRES)
def test_decode_matches_jax(name):
    """int16 and float32 bit for bit; mu-law within EAGER_ULPS of eager JAX
    and JIT_ULPS of jitted JAX. Every code of the mu-law wires goes through, and an odd row."""
    n = 999
    if name == "mulaw8":
        enc = np.arange(256, dtype=np.uint8)[None].repeat(2, 0)
        n = 256
    elif name == "mulaw12":
        codes = np.arange(4096, dtype=np.uint32)  # pack every code, two a 3-byte group
        enc = np.stack([codes[0::2] >> 4, ((codes[0::2] & 0xF) << 4) | (codes[1::2] >> 8),
                        codes[1::2] & 0xFF], axis=-1).reshape(1, -1).astype(np.uint8)
        n = 4095
    else:
        enc = wire.encode_wire(_wave((2, 1000), 7), name)
    got = wire.decode_wire_device(torch.from_numpy(enc), name, n_samples=n).numpy()
    eager = np.asarray(jax_wire.decode_wire_device(jnp.asarray(enc), wire=name, n_samples=n))
    jitted = np.asarray(jax.jit(lambda a: jax_wire.decode_wire_device(a, wire=name, n_samples=n))(
        jnp.asarray(enc)))
    assert got.dtype == np.float32 and got.shape == eager.shape
    if name in ("int16", "float32"):
        np.testing.assert_array_equal(got, eager)
    else:
        assert _within_ulps(got, eager, EAGER_ULPS) and _within_ulps(got, jitted, JIT_ULPS)
    silence = wire.silence_buffer(name, 2, 101)
    peak = float(wire.decode_wire_device(torch.from_numpy(silence), name, n_samples=101).abs().max())
    # mulaw8 has no exact zero code: 128 decodes to 8.6e-5, as in the JAX package
    assert peak < 1e-4 if name == "mulaw8" else peak == 0.0


def test_mulaw12_odd_rows_and_silence_code():
    w = _wave(777, 3)
    enc = wire.encode_wire(w, "mulaw12")
    assert len(enc) == 3 * 389  # 777 samples + one silence sample, 3 bytes a pair
    full = wire.decode_wire_device(torch.from_numpy(enc), "mulaw12").numpy()
    assert full.shape == (778,) and full[-1] == 0.0
    with pytest.raises(ValueError, match="packed"):
        wire.wire_zero("mulaw12")
    assert wire.wire_zero("mulaw8") == 128


@pytest.mark.parametrize("n", [1, 2, 5, 129, 1000, 44101])
def test_decimate_matches_jax_bit_for_bit(n):
    """A 1-D waveform through the JAX package's native FIR (its arithmetic
    the port repeats in numpy); a batch through scipy in both."""
    assert jax_native_lib() is not None, "the JAX package's native FIR did not build"
    rng = np.random.default_rng(n)
    x = (0.4 * np.sin(np.arange(n) * 0.05) + 0.01 * rng.standard_normal(n)).astype(np.float32)
    np.testing.assert_array_equal(wire_decimation_taps(2), jax_taps(2))
    got = decimate_wire(x, 2)
    assert got.dtype == np.float32 and got.shape == (-(-n // 2),)
    np.testing.assert_array_equal(got, jax_decimate_wire(x, 2))
    batch = np.stack([x, x[::-1]])
    np.testing.assert_array_equal(decimate_wire(batch, 2), jax_decimate_wire(batch, 2))
    np.testing.assert_array_equal(decimate_wire(x, 1), x)


def test_half_rate_log_mel_matches_jax():
    """The wire-domain mel of the half-rate wire: geometry halved, magnitude
    scale 2, on audio decimated once."""
    t = np.arange(SR) / SR
    rng = np.random.default_rng(5)
    audio = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(SR)).astype(np.float32)
    half = decimate_wire(audio, 2)
    want = np.asarray(JaxLogMelSpec(80, SR // 2, 1024, 256, fmin=40, fmax=8000,
                                    mag_scale=2.0)(half))
    got = LogMelSpec(80, SR // 2, 1024, 256, fmin=40, fmax=8000, mag_scale=2.0)(
        torch.from_numpy(half)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    native = LogMelSpec(80, SR, 2048, 512, fmin=40, fmax=8000)(torch.from_numpy(audio)).numpy()
    assert got.shape == native.shape
    # the equivalent analysis: within the decimation filter's ripple
    assert np.abs(got - native).mean() < 1e-3
