"""The harness is driven by data: every cell found by name from its files,
a new cell, mix and metric added as files alone, and the result line's
shape."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import run as R
from benchmark.tests.conftest import ROOT, TINY_CONFIG, TINY_MIX, tiny_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keeps_the_contract():
    man = R.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in man[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells
            assert R.applies(e2e[m["moves"]], {"name": cell}, set())


@pytest.mark.parametrize("cell", [w["name"] for w in R.manifest()["workloads"]])
def test_each_cell_is_found_by_name(cell):
    import importlib

    man, spec, entry, config, mix, limits = R.find_cell(cell)
    assert (ROOT / entry["file"]).is_file() and config["midi_extractor_args"]
    importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    e2e = [m["name"] for m in man["end_to_end"] if R.applies(m, spec, set())]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in man["per_layer"] if R.applies(m, spec, set(e2e))]
    assert layer
    for m in layer:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def test_a_new_cell_mix_and_metric_from_files_alone(tmp_path):
    """A copy of the benchmark gains a cell on a new mix (two clients) with
    a new per-layer metric, by new files and manifest entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = R.manifest()
    man["workloads"].append({"name": "conformer8-bf16.serve-pair", "config": "conformer8-bf16",
                             "traffic": "serve-pair", "chips": 1, "why": "two clients"})
    for m in man["end_to_end"]:
        if m["name"] == "serve_rtf":
            m["workloads"].append("conformer8-bf16.serve-pair")
    man["per_layer"].append({"name": "songs_answered.pair", "unit": "songs", "better": "higher",
                             "source": "program_counter", "layer": "service",
                             "moves": "serve_rtf", "workloads": ["conformer8-bf16.serve-pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    mix = json.loads((ROOT / "benchmark" / "traffic" / "serve-backlog.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "serve-pair.json").write_text(
        json.dumps(dict(mix, clients=2)))
    shutil.copy(ROOT / "benchmark" / "limits" / "conformer8-bf16.serve-backlog.json",
                tmp_path / "benchmark" / "limits" / "conformer8-bf16.serve-pair.json")
    (tmp_path / "benchmark" / "metrics" / "songs_answered.pair.py").write_text(
        "def read(obs):\n    return obs['dispatcher']['requests']\n")

    out = tiny_run("conformer8-bf16.serve-pair", root=tmp_path, mix={"clients": 2})
    result = out["result"]
    assert result["correct"] and set(result["metrics"]) == {"serve_rtf", "setup_s"}
    assert result["metrics"]["serve_rtf"]["value"] > 0
    traced = R.run_cell("conformer8-bf16.serve-pair", 5, 3.0, True, device="cpu",
                        root=tmp_path, config_overrides=TINY_CONFIG,
                        mix_overrides=dict(TINY_MIX, clients=2))
    assert traced["result"]["metrics"]["songs_answered.pair"]["value"] > 0
    assert "jobs_per_batch.backlog" not in traced["result"]["metrics"]


def test_the_result_line_shape():
    result = tiny_run("conformer8-bf16.serve-backlog")["result"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(result))


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "conformer8-bf16.serve-backlog", "--seed", "1",
                   "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_restart_puts_the_train_state_back():
    """A step, the state restarted in place, the same step again: the same
    loss, weights and optimizer state as the first time (the set-up's warm
    visits leave the checked steps a state as fresh as the seed's)."""
    import torch

    from benchmark.drivers.train import make_items, restart
    from some_tpu_torch.train import build_task

    config = dict(R.find_cell("conformer8-bf16.train")[3], **TINY_CONFIG, seed=7)
    task = build_task(config, device="cpu")
    state = task.init_state()
    weights = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    buffers = {n: b.detach().clone() for n, b in state.model.named_buffers()}
    batch = task.collate(make_items(7, [120, 96], config["units_dim"], "cpu"))

    def step():
        loss = float(task.train_step(state, batch)["total_loss"])
        moments = [v.clone() for s in state.optimizer.state.values() for v in s.values()]
        return loss, {n: p.detach().clone() for n, p in state.model.named_parameters()}, moments

    first = step()
    task.train_step(state, batch)
    restart(state, weights, buffers)
    assert state.step == 0
    again = step()
    assert again[0] == first[0]
    assert all(torch.equal(again[1][n], first[1][n]) for n in weights)
    assert all(torch.equal(a, b) for a, b in zip(again[2], first[2]))


def test_a_held_call_holds_the_profilers_gate():
    import threading

    from benchmark.harness.trace import DeviceTrace, hold

    gate = threading.Lock()
    seen = []

    class Engine:
        def infer(self, x):
            seen.append(gate.locked())
            return x + 1

    engine = Engine()
    hold(engine, "infer", gate)
    assert engine.infer(1) == 2 and seen == [True] and not gate.locked()
    assert DeviceTrace(gate).gate is gate and not DeviceTrace().gate.locked()
