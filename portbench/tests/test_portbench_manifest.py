"""BENCHMARK.json against the contract's shape, and every piece a cell
names found by name under portbench/."""

import json
import re

from small import ROOT

from portbench.run import BENCH

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|_rank$|expan|per_tok|embd|embed)")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_allowed_characters():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        listed = [x["name"] for x in b[group]]
        assert len(listed) == len(set(listed)), group
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    for text in [w["why"] for w in b["workloads"]] + [c["why"] for c in b["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_entry_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in b["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in b["workloads"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(b)) <= 64 * 1024
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51


def test_every_cell_finds_its_files_by_name():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"] == 1
        assert cell["why"] == w["why"]
        assert (BENCH / "drivers" / f"{cell['driver']}.py").exists()
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["reduced"] == configs[w["config"]]["reduced"]
        assert not any(WIDTH.search(k) for k in cfg["reduced"])
        assert all(v is not None for v in cell["limits"].values()), w["name"]
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:  # setup_s, one more end-to-end metric and one per-layer metric
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    layers = {}
    for m in b["per_layer"]:  # metrics of one layer give one layer name
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
