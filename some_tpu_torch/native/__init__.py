"""The port's native host plane: ``audio_frontend.cpp`` built with g++ and
bound with ``ctypes``.

Counterpart of ``some_tpu/native``: the RMS envelope and the silence scan of
the slicer, and the FIR decimator of the half-rate wire, in C++ with the
JAX package's ``extern "C"`` ABI and arithmetic. The library is compiled on
first use with ``g++ -O3 -march=native -shared -fPIC`` into
``build/libsome_audio-<key>.so`` at the repository root; the key hashes the
source, the flags and the host's CPU flag set, since a ``-march=native``
build copied to another CPU could load and then fault on an instruction.

Each compile runs under an exclusive ``fcntl.flock`` on
``build/<name>.lock`` and writes to a temporary name that ``os.replace``
moves into place, so processes that start at once compile the library once
and none ever loads a half-written file.

Where g++ or ``-march=native`` fails, ``native_available()`` is False and
the callers run the plain versions, as the JAX package does: the slicer its
Python scan (``audio/slicer.py``), the wire its numpy FIR
(``audio/wavio.py``), with the same outputs. Each entry point counts its
calls (``rms_envelope_native.calls``, ...), so a caller can tell which path
ran. Nothing here builds at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "audio_frontend.cpp"
BUILD_DIR = SRC.parent.parent.parent / "build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_failure = None  # why the library is unavailable in this process, once known

_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)


def _host_key() -> str:
    """The machine and its CPU flag set (``/proc/cpuinfo``), as in
    ``some_tpu/native/__init__.py``."""
    flags = ""
    try:
        with open("/proc/cpuinfo", "r", encoding="utf8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine() + ":" + " ".join(sorted(flags.split()))


def library_path() -> pathlib.Path:
    """Where the library built from SRC with GXX_FLAGS on this host lives."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_host_key().encode())
    return BUILD_DIR / f"libsome_audio-{digest.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the library into BUILD_DIR unless it is there: (path, whether
    this call compiled it). Raises ``RuntimeError`` with g++'s output if the
    compile fails, ``OSError`` if g++ cannot run."""
    path = library_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():
            return path, False
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            out = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed (exit {out.returncode}):\n{out.stderr}")
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return path, True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rms_envelope.argtypes = [_F32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _F64,
                                 ctypes.c_int64]
    lib.rms_envelope.restype = None
    lib.slicer_scan.argtypes = [_F64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64, _I64, ctypes.c_int64]
    lib.slicer_scan.restype = ctypes.c_int64
    lib.decimate_fir.argtypes = [_F32, ctypes.c_int64, _F32, ctypes.c_int64, ctypes.c_int64,
                                 _F32, ctypes.c_int64]
    lib.decimate_fir.restype = None
    return lib


def get_lib():
    """The bound library, built on first use; None if it cannot be built or
    loaded here (``unavailable_reason()`` says why)."""
    global _lib, _failure
    with _lock:
        if _lib is None and _failure is None:
            try:
                path, _ = build()
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
                _failure = f"{type(exc).__name__}: {exc}"
        return _lib


def native_available() -> bool:
    """Whether the native host plane runs in this process."""
    return get_lib() is not None


def unavailable_reason():
    """Why ``native_available()`` is False (None while it is True or untried)."""
    return _failure


def _need_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native host plane is unavailable: {_failure}")
    return lib


def rms_envelope_native(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered RMS per frame (float64), ``audio/slicer.py::rms_envelope``
    in C++."""
    lib = _need_lib()
    y = np.ascontiguousarray(y, dtype=np.float32)
    pad = frame_length // 2
    num_frames = (len(y) + 2 * pad - frame_length) // hop_length + 1
    out = np.empty(max(num_frames, 0), dtype=np.float64)
    lib.rms_envelope(y.ctypes.data_as(_F32), len(y), frame_length, hop_length,
                     out.ctypes.data_as(_F64), len(out))
    rms_envelope_native.calls += 1
    return out


def slicer_scan_native(rms: np.ndarray, threshold: float, min_interval: int,
                       min_length: int, max_sil_kept: int) -> list:
    """Silence tags [(start, end)] in RMS frames,
    ``audio/slicer.py::scan_silence`` in C++."""
    lib = _need_lib()
    rms = np.ascontiguousarray(rms, dtype=np.float64)
    # a tag needs min_interval frames of silence, and the last one may follow
    capacity = max(len(rms) // max(min_interval, 1) + 8, 16)
    tags = np.empty(capacity * 2, dtype=np.int64)
    count = lib.slicer_scan(rms.ctypes.data_as(_F64), len(rms), float(threshold), min_interval,
                            min_length, max_sil_kept, tags.ctypes.data_as(_I64), capacity)
    slicer_scan_native.calls += 1
    return [(int(tags[2 * i]), int(tags[2 * i + 1])) for i in range(count)]


def decimate_fir_native(x: np.ndarray, taps: np.ndarray, factor: int) -> np.ndarray:
    """Polyphase FIR decimation of a 1-D float32 signal by ``factor`` with
    odd gain-1 taps, ``audio/wavio.py::_decimate_fir`` in C++."""
    lib = _need_lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    if x.ndim != 1 or taps.ndim != 1 or factor < 1:
        raise ValueError(f"decimate_fir_native: 1-D x and taps and factor >= 1, got x "
                         f"{x.shape}, taps {taps.shape}, factor {factor}")
    n_out = (len(x) + factor - 1) // factor
    out = np.empty(n_out, dtype=np.float32)
    lib.decimate_fir(x.ctypes.data_as(_F32), len(x), taps.ctypes.data_as(_F32), len(taps),
                     factor, out.ctypes.data_as(_F32), n_out)
    decimate_fir_native.calls += 1
    return out


def reset_calls() -> None:
    """Set every entry point's call count to 0."""
    for fn in ENTRY_POINTS:
        fn.calls = 0


def read_calls() -> dict:
    """Entry point name -> its calls since the last ``reset_calls``."""
    return {fn.__name__: fn.calls for fn in ENTRY_POINTS}


ENTRY_POINTS = (rms_envelope_native, slicer_scan_native, decimate_fir_native)
reset_calls()
