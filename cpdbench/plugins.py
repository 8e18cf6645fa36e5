"""Finding a cell's parts by name: the files under ``cpdbench/`` that
``BENCHMARK.json`` names, each in a folder of its kind.

    configs/<config>.json     a configuration's sizes
    traffic/<mix>.json        a traffic mix's parameters
    cells/<workload>.json     a cell's comparison: what is compared, limits
    metrics/<metric>.py       a metric's reader: read(record) -> number|None
                              (a dotted name falls back to its first part)
    counts/<name>.py          work counts of a kernel or a method
    peaks.json                the cards' published peaks
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

_modules: dict[Path, object] = {}


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def data(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    return load_json(BENCH / kind / f"{_checked(name)}.json")


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded once by its
    path (a name may hold dots and dashes, which an import cannot)."""
    path = BENCH / kind / f"{_checked(name)}.py"
    if path not in _modules:
        spec = importlib.util.spec_from_file_location(
            f"cpdbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or, for a
    name split by cell kind (``fit_s.tucker``), the reader of the part
    before the first dot."""
    if (BENCH / "metrics" / f"{_checked(name)}.py").is_file():
        return module("metrics", name)
    return module("metrics", name.split(".")[0])


def peak_for(kind: str):
    """The published peaks of the card named ``kind`` (the first entry of
    ``peaks.json`` whose ``match`` is in the name), or None."""
    for entry in load_json(BENCH / "peaks.json")["cards"]:
        if entry["match"] in kind:
            return entry
    return None
