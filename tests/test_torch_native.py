"""The port's native host plane (some_tpu_torch/native) against the JAX
package's (some_tpu/native) and against the port's plain versions, on the
signals of tests/test_native.py: the RMS envelope, the silence scan and the
FIR decimator bit for bit against the JAX library; tags and FIR bits equal
to the plain versions; six spawned processes building one library at once;
the fallback when the library cannot be built."""
import multiprocessing
import queue

import numpy as np
import pytest

import some_tpu.native as jax_native
from some_tpu_torch import native
from some_tpu_torch.audio.slicer import SilenceSlicer, rms_envelope, scan_silence
from some_tpu_torch.audio.wavio import _decimate_fir, decimate_wire, wire_decimation_taps
from tests.test_torch_wire import load_jax_native
from tests.torch_native_worker import build_and_run

SR = 44100


def make_signal(rng, seconds=20, sr=SR):
    """Alternating tone/silence segments with random durations (the signal of
    tests/test_native.py)."""
    parts = []
    t_left = seconds
    while t_left > 0:
        dur = float(rng.uniform(0.3, 4.0))
        dur = min(dur, t_left)
        n = int(dur * sr)
        if rng.random() < 0.45:
            parts.append(np.zeros(n, np.float32))
        else:
            freq = rng.uniform(100, 800)
            t = np.arange(n) / sr
            parts.append((0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32))
        t_left -= dur
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def libs():
    """Both native libraries, loaded."""
    load_jax_native()
    assert native.native_available(), native.unavailable_reason()


@pytest.mark.parametrize("seed", [0, 1])
def test_rms_envelope_matches_jax(libs, seed):
    y = make_signal(np.random.default_rng(seed), seconds=8)
    got = native.rms_envelope_native(y, 3528, 882)
    np.testing.assert_array_equal(got, jax_native.rms_envelope_native(y, 3528, 882))
    want = rms_envelope(y, frame_length=3528, hop_length=882)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_scan_matches_jax_and_plain(libs, seed):
    y = make_signal(np.random.default_rng(seed), seconds=25)
    slicer = SilenceSlicer(sr=SR, max_sil_kept=1000)
    rms = rms_envelope(y, frame_length=slicer.win_size, hop_length=slicer.hop_size)
    args = (slicer.threshold, slicer.min_interval, slicer.min_length, slicer.max_sil_kept)
    got = native.slicer_scan_native(rms, *args)
    assert len(got) > 1
    assert got == jax_native.slicer_scan_native(rms, *args)
    assert got == [(int(a), int(b)) for a, b in scan_silence(rms, *args)]


@pytest.mark.parametrize("n", [7, 64, 129, 130, 1000, 44100 * 3 + 1])
def test_decimate_fir_matches_jax_and_plain(libs, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    taps = wire_decimation_taps(2)
    got = native.decimate_fir_native(x, taps, 2)
    assert got.dtype == np.float32 and got.shape == (-(-n // 2),)
    np.testing.assert_array_equal(got, jax_native.decimate_fir_native(x, taps, 2))
    np.testing.assert_array_equal(got, _decimate_fir(x, taps, 2))


def test_decimate_fir_factor_3_matches_jax_and_plain(libs):
    from scipy.signal import firwin

    taps = firwin(64 * 3 + 1, 1 / 3, window=("kaiser", 12.0)).astype(np.float32)
    x = np.random.default_rng(3).standard_normal(100001).astype(np.float32)
    got = native.decimate_fir_native(x, taps, 3)
    np.testing.assert_array_equal(got, jax_native.decimate_fir_native(x, taps, 3))
    np.testing.assert_array_equal(got, _decimate_fir(x, taps, 3))


def test_decimate_fir_of_pcm_audio_matches_jax_and_plain(libs):
    """Audio decoded from 16-bit PCM sits on a coarse grid, where an f64 sum
    lands on the midpoint between two f32 values now and then: the plain
    version rounds such sums once, as the FMA does (9 of these 220500
    outputs differ by an ulp when the f64 sum is rounded to f32 twice)."""
    t = np.arange(SR * 10) / SR
    f = 440 * 2 ** (np.floor(t * 2) % 7 / 12)
    x = (np.round(0.45 * np.sin(2 * np.pi * f * t) * 32767) / 32768).astype(np.float32)
    taps = wire_decimation_taps(2)
    got = native.decimate_fir_native(x, taps, 2)
    np.testing.assert_array_equal(got, jax_native.decimate_fir_native(x, taps, 2))
    np.testing.assert_array_equal(got, _decimate_fir(x, taps, 2))


@pytest.mark.parametrize("seed", [7, 8])
def test_slice_takes_the_native_path_with_the_plain_chunks(libs, seed):
    """SilenceSlicer.slice runs the C++ envelope and scan (one call each)
    and gives the chunks of the plain versions."""
    y = make_signal(np.random.default_rng(seed), seconds=30)
    slicer = SilenceSlicer(sr=SR, max_sil_kept=1000)
    native.reset_calls()
    chunks = slicer.slice(y)
    assert native.read_calls() == {"rms_envelope_native": 1, "slicer_scan_native": 1,
                                   "decimate_fir_native": 0}
    rms = rms_envelope(y, frame_length=slicer.win_size, hop_length=slicer.hop_size)
    want = slicer.apply_tags(y, scan_silence(rms, slicer.threshold, slicer.min_interval,
                                             slicer.min_length, slicer.max_sil_kept),
                             rms.shape[0])
    assert len(chunks) == len(want) > 1
    for a, b in zip(chunks, want):
        assert a["offset"] == b["offset"]
        np.testing.assert_array_equal(a["waveform"], b["waveform"])


def test_without_the_library_the_plain_versions_run(libs, monkeypatch, tmp_path):
    """Where g++ fails (here: on a -march it does not know), the slicer and
    the wire take their plain versions,
    with the same outputs, and no native entry point runs."""
    y = make_signal(np.random.default_rng(9), seconds=30)
    slicer = SilenceSlicer(sr=SR, max_sil_kept=1000)
    want_chunks = slicer.slice(y)
    want_fir = decimate_wire(y, 2)
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-march=no-such-cpu",))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.reset_calls()
    assert not native.native_available()
    assert "g++ failed" in native.unavailable_reason()
    got_chunks = slicer.slice(y)
    assert [c["offset"] for c in got_chunks] == [c["offset"] for c in want_chunks]
    np.testing.assert_array_equal(decimate_wire(y, 2), want_fir)
    assert not any(native.read_calls().values())
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decimate_fir_native(y, wire_decimation_taps(2), 2)


def test_concurrent_processes_build_once_and_agree(tmp_path):
    """Six processes started together build into one empty directory: one
    compiles, every one loads a whole library (a compile goes to a temporary
    name and is renamed into place under a file lock) and all give the same
    bits."""
    ctx = multiprocessing.get_context("spawn")
    n = 6
    barrier, results = ctx.Barrier(n), ctx.Queue()
    procs = [ctx.Process(target=build_and_run, args=(str(tmp_path), barrier, results))
             for _ in range(n)]
    for p in procs:
        p.start()
    try:
        outs = [results.get(timeout=240) for _ in range(n)]
    except queue.Empty:
        outs = None
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    assert outs is not None, "a worker did not report"
    assert not any(p.is_alive() for p in procs)
    errors = [o for o in outs if o[0] == "error"]
    assert not errors, errors
    assert sum(o[0] for o in outs) == 1, [o[0] for o in outs]
    assert all(o[1:] == outs[0][1:] for o in outs)
    assert outs[0][4] is None and len(outs[0][2]) > 0
    assert len(list(tmp_path.glob("*.so"))) == 1 and not list(tmp_path.glob("*.tmp"))


def test_calls_are_counted(libs):
    native.reset_calls()
    x = np.zeros(1000, np.float32)
    native.decimate_fir_native(x, wire_decimation_taps(2), 2)
    decimate_wire(x, 2)
    decimate_wire(np.stack([x, x]), 2)  # a batch takes scipy, not the native FIR
    rms = native.rms_envelope_native(x, 64, 16)
    native.slicer_scan_native(rms, 0.01, 2, 4, 4)
    assert native.read_calls() == {"rms_envelope_native": 1, "slicer_scan_native": 1,
                                   "decimate_fir_native": 2}
