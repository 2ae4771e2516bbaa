"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names compared whole (``some_tpu_torch`` is the port, ``some_tpu``
the JAX package)."""
from __future__ import annotations

import subprocess
import sys
import types

from benchmark import run as R
from benchmark.tests.conftest import ROOT

CHILD = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests.conftest import tiny_run
from benchmark.run import forbidden_modules
import benchmark.control
tiny_run("conformer8-int8.serve-backlog", seconds=2.0)
tiny_run("conformer8-bf16.train", seconds=2.0, mix={{"hours": 0.03, "warm_epochs": 1}})
print("FORBIDDEN", forbidden_modules(), "PORT", "some_tpu_torch" in sys.modules)
"""


def test_a_run_loads_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN [] PORT True"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "some_tpu_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "some_tpu.audio", types.ModuleType("x"))
    assert R.forbidden_modules() == ["some_tpu"]
