"""The worker of tests/test_torch_native.py's concurrent-build test, in a
module of its own so that a spawned process imports numpy and the port's
native loader only."""
import pathlib

import numpy as np


def build_and_run(build_dir: str, barrier, results) -> None:
    """Wait for every worker, build the native library into ``build_dir``,
    load it and put (whether this process compiled it, the outputs of the
    three entry points on a seeded signal) on ``results``."""
    from some_tpu_torch import native

    native.BUILD_DIR = pathlib.Path(build_dir)
    barrier.wait(timeout=60)
    try:
        _, compiled = native.build()
        # a tone with a 0.6 s gap every 2 s
        t = np.arange(44100 * 8)
        y = (0.3 * np.sin(t * 0.03) * (t % 88200 < 61740)).astype(np.float32)
        rms = native.rms_envelope_native(y, 3528, 882)
        tags = native.slicer_scan_native(rms, 0.01, 10, 50, 50)
        fir = native.decimate_fir_native(y, np.hanning(129).astype(np.float32) / 64.5, 2)
        results.put((compiled, rms.tobytes(), tags, fir.tobytes(), native.unavailable_reason()))
    except Exception as exc:  # reported to the parent, which fails the test
        results.put(("error", f"{type(exc).__name__}: {exc}"))
