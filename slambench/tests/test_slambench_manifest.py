"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the cells' metrics and the files the harness finds by name."""

import dataclasses
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for kind, key in (("configs", "config"), ("workloads", "workload")):
        for e in MANIFEST[kind]:
            assert set(e) == KEYS[key]
    for kind in ("end_to_end", "per_layer"):
        for e in MANIFEST[kind]:
            assert set(e) - {"workloads"} == KEYS[kind]
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


def test_names_units_and_lines():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
    for kind in ("configs", "workloads"):
        got = [n for k, n in names if k == kind]
        assert len(got) == len(set(got))
    metrics = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for e in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in MANIFEST["configs"]:
        assert _line(e["source"]) and _line(e["why"])
        assert len(e["reduced"]) <= 16
        assert all(NAME.match(k) for k in e["reduced"])
    for w in MANIFEST["workloads"]:
        assert _line(w["why"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])
    assert all(_line(c) for c in MANIFEST["command"])
    assert len(MANIFEST["command"]) <= 32


def test_paths_and_files():
    paths = MANIFEST["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and ".." not in p.split("/")
        assert not p.startswith("/") and not p.endswith("_torch")
    for c in MANIFEST["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        assert (ROOT / c["file"]).exists()
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for w in MANIFEST["workloads"]:
        assert (ROOT / "slambench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "slambench" / "limits" / f"{w['name']}.json").exists()


def test_pairs_chips_and_run_seconds():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in MANIFEST["workloads"]} == {
        c["name"] for c in MANIFEST["configs"]}
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(WORKLOADS) // 4)
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", WORKLOADS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) and m["moves"] in e2e
               for m in MANIFEST["per_layer"])


def test_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", WORKLOADS)
        assert set(cells) <= set(WORKLOADS) and cells
        for cell in cells:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    MANIFEST["end_to_end"]
                                    + MANIFEST["per_layer"]])
def test_every_metric_has_a_reader(metric):
    from slambench.cell import metric_reader

    assert callable(metric_reader(ROOT, metric))


def test_vlp16_reduced_lists_every_change_from_the_source():
    from msst_torch.models.liosam.params import LioParams

    cfg = json.loads((ROOT / "slambench/configs/vlp16.json").read_text())
    entry = {c["name"]: c for c in MANIFEST["configs"]}["vlp16"]
    base = dataclasses.asdict(LioParams())
    changed = {k for k, v in cfg["params"].items()
               if (list(base[k]) if isinstance(base[k], tuple) else base[k])
               != v}
    assert changed == set(entry["reduced"]) == set(cfg["reduced"])
