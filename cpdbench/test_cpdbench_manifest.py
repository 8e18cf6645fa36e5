"""BENCHMARK.json against the benchmark's rules, before any run on the
card: the keys of every entry, names and units, the files each entry
names, the cells' chips, and which end-to-end metric each per-layer metric
moves."""
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def one_line(text, limit=200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_size():
    assert set(MANIFEST) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    paths = MANIFEST["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:  # a file of the repo: under paths
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).is_file()


def test_run_seconds_fits_a_full_check():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"file", "name", "reduced", "source", "why"}
    assert NAME.match(entry["name"])
    assert one_line(entry["source"]) and one_line(entry["why"])
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    assert any(entry["file"].startswith(p + "/") for p in MANIFEST["paths"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert entry["source"] == cfg["source"]


def test_config_files_distinct_and_used():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] in (1, 4)
    assert one_line(cell["why"])
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (BENCH / "cells" / f"{cell['name']}.json").is_file()


def test_cells_unique_and_four_chip_share():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


@pytest.mark.parametrize("metric", _metrics(), ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in MANIFEST["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert one_line(metric["layer"])
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    reader = BENCH / "metrics" / f"{metric['name']}.py"
    base = BENCH / "metrics" / f"{metric['name'].split('.')[0]}.py"
    assert reader.is_file() or base.is_file()
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_metric_names_unique_and_setup_present():
    names = [m["name"] for m in _metrics()]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


def _reports(metric, cell) -> bool:
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for cell in cells:
        if _reports(metric, cell):
            assert _reports(e2e[metric["moves"]], cell), (metric, cell)


def test_every_cell_reports_enough():
    for w in MANIFEST["workloads"]:
        cell = w["name"]
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if _reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, cell) for m in MANIFEST["per_layer"])


def test_layers_one_name_each():
    # one spelling per layer, as PERF.md's list of layers has it
    perf = (ROOT / "PERF.md").read_text()
    for m in MANIFEST["per_layer"]:
        assert f"**{m['layer']}**" in perf, m["layer"]


def test_rooflines_are_percent():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_files_under_paths_named_by_names():
    for p in MANIFEST["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                rel = f.relative_to(ROOT).as_posix()
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
