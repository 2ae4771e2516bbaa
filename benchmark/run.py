"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout. It names a configuration (``benchmark/configs/<name>.json``,
through ``configs``) and a traffic mix (``benchmark/traffic/<mix>.json``),
whose ``driver`` names the module of ``benchmark/drivers`` that sets up,
measures and checks. The limits of the check are
``benchmark/limits/<cell>.json``. With ``--trace 1`` the result carries the
cell's per-layer metrics, each read by ``benchmark/metrics/<metric>.py``
from what the driver observed; with ``--trace 0`` its end-to-end metrics.

Without a CUDA card (or with fewer than the cell's chips) it exits 2 and
prints no result; if anything of JAX or the JAX package was imported, 3.
A run that has printed no result ``WATCHDOG_S`` seconds after its start
writes every thread's stack to standard error and exits 1.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# run as a script, its own folder leads sys.path: the checkout's root instead
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == BENCH:
    sys.path[0] = str(ROOT)
#: top-level module names that may not be loaded in the process that
#: prints the result: JAX and the JAX package (the port, some_tpu_torch, is
#: another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "some_tpu")
#: seconds from the process's start after which a run without its result is
#: taken as stuck (a run has 360; its runs take 90 to 200)
WATCHDOG_S = 345.0


@dataclass
class Context:
    """What a driver gets for one run."""
    cell: dict
    #: the configuration the program runs
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = T_START
    #: also judge the control (the reference in the precision below) on the sample
    control: bool = False
    #: a function applied to the program's engine or task once built (tests)
    fault: Optional[Callable] = None
    #: the compared numbers' raw readings, for the limits' records
    readings: dict = field(default_factory=dict)
    #: the configuration the reference judges by (the cell's own)
    judge_config: Optional[dict] = None


def manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(name: str, root: pathlib.Path = ROOT):
    """(manifest, cell, config entry, config dict, mix, limits) of a cell."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())["config"]
    mix = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text())
    return man, cell, entry, config, mix, limits


def applies(metric: dict, cell: dict, reported: set) -> bool:
    """Whether a metric belongs in this cell's line: its ``workloads`` name
    the cell, or it has none and the cell reports the metric it moves."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def read_metric(name: str, obs: dict, root: pathlib.Path = ROOT):
    """The per-layer metric ``name`` from the driver's observations, by its
    reader ``benchmark/metrics/<name>.py`` (None: nothing to read)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    module_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(obs)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: pathlib.Path = ROOT, config_overrides: Optional[dict] = None,
             mix_overrides: Optional[dict] = None, control: bool = False,
             fault: Optional[Callable] = None, t_start: float = T_START,
             program_overrides: Optional[dict] = None) -> dict:
    """One run of a cell: the result object (the contract's keys, then
    ``checks`` last) and the driver's raw readings under ``readings``.
    ``config_overrides`` change the configuration of both sides (the tests'
    small widths), ``program_overrides`` the program's alone (a control
    path of the program's own), ``fault`` breaks the program (tests)."""
    man, cell, entry, config, mix, limits = find_cell(workload, root)
    config = dict(config, **(config_overrides or {}))
    mix = dict(mix, **(mix_overrides or {}))
    ctx = Context(cell=cell, config=dict(config, **(program_overrides or {})), mix=mix,
                  limits=limits, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=device, t_start=t_start, control=control, fault=fault,
                  judge_config=config)
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    out = driver.run(ctx)

    e2e_specs = [m for m in man["end_to_end"] if applies(m, cell, set())]
    reported = {m["name"] for m in e2e_specs}
    metrics = {}
    if not trace:
        for m in e2e_specs:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        for m in man["per_layer"]:
            if applies(m, cell, reported):
                value = read_metric(m["name"], out["obs"], root)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": value, "limit": limit} for name, value, limit in out["checks"]}
    correct = all(_within(c["value"], c["limit"]) for c in checks.values())
    device_info = _device(device, out)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace and "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return {"result": result, "readings": ctx.readings}


def _within(value, limit) -> bool:
    return isinstance(value, (int, float)) and math.isfinite(value) and value <= limit


def _device(device: str, out: dict) -> dict:
    import torch

    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if "busy_s" in out:
        info["busy_s"], info["window_s"] = out["busy_s"], out["window_s"]
    return info


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _fixed_caches(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "cache"
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = str(cache / sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    faulthandler.dump_traceback_later(max(WATCHDOG_S - (time.monotonic() - T_START), 1.0),
                                      exit=True, file=sys.__stderr__)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    _fixed_caches(ROOT)
    cell = find_cell(args.workload)[1]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))["result"]
    faulthandler.cancel_dump_traceback_later()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}: nothing of JAX or the JAX package may "
              "run here", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
