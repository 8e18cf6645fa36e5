"""The harness rehearsed on the CPU at a tiny size: a whole run prints its
result with the numbers compared, loads no JAX and nothing of the JAX
package, refuses to run without a card, and comes out as not correct when
the timed path is broken underneath it."""
import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cpdbench import harness
from cpdbench.test_cpdbench_control import SMALL

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("yelp-uniform.cp-restarts", "yelp-uniform.tucker-restarts")
SEED = 2**31 + 17
# a fault reads far over any limit at any size
TINY = {"dims": [60, 40, 80], "nnz": 5000}


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a test process: the suite runs several processes at
    once, and these fits gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str, size=None) -> harness.Cell:
    """The cell at ``size``, by default the control test's size for its
    configuration, where sound runs fall inside the cell's limits, with one
    fit a traced pass."""
    cell = harness.load_cell(name)
    cell.cfg = dict(cell.cfg, **(size or SMALL[cell.cfg["name"]]))
    cell.mix = dict(cell.mix, trace_plain_fits=1, trace_profiled_fits=1,
                    trace_timed_fits=1)
    return cell


def run(name: str, trace: bool = False, size=None) -> tuple[dict, str]:
    out, err = io.StringIO(), io.StringIO()
    # a window of 0 s holds exactly one fit, so the fits compared do not
    # depend on the machine's speed
    result = harness.Runner(tiny_cell(name, size), SEED, 0.0, trace, "cpu",
                            0.0, out=out, err=err, forbidden=()).run()
    last = out.getvalue().strip().splitlines()[-1]
    assert json.loads(last) == result
    return result, err.getvalue()


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    e["OMP_NUM_THREADS"] = "2"
    return e


REHEARSAL = """
import json, sys
from cpdbench import harness
from cpdbench.test_cpdbench_control import SMALL
cell = harness.load_cell("yelp-uniform.cp-restarts")
cell.cfg = dict(cell.cfg, **SMALL["yelp-uniform"])
r = harness.Runner(cell, 5, 0.0, False, "cpu", 0.0).run()
assert r is not None and r["correct"], r
print("LOADED", json.dumps(harness.loaded_top_level(
    harness.FORBIDDEN_MODULES + ("torch",))))
"""


def test_fresh_process_loads_nothing_forbidden():
    p = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT,
                       env=env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("LOADED")][0]
    assert json.loads(line.split(" ", 1)[1]) == ["torch"]


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "cpdbench/run.py", "--workload",
         "yelp-uniform.cp-restarts",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_sound_run_is_correct(name, trace):
    result, err = run(name, trace)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(tiny_cell(name).checks["limits"])
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    # the last lines of standard error: each number beside its limit
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)
    metrics = result["metrics"]
    if trace:
        assert "sort_s" in metrics
        assert ("mttkrp_ms" in metrics) != ("ttmc_ms" in metrics)
        assert "breakdown" in result
        # no card: no roofline, no busy share, no share of the peak
        assert not any(k.endswith("_roofline") or k.startswith("device_")
                       or "mfu" in k for k in metrics)
    else:
        # no card: no peak memory
        fit = "fit_s.tucker" if "tucker" in name else "fit_s.cp"
        assert set(metrics) == {fit, "setup_s"}
        assert metrics[fit]["value"] > 0


# -- faults planted under the harness -------------------------------------

# the package's attributes ``cp_als`` and ``tucker_hooi`` are the functions,
# so the modules are looked up by their full names


def _stuck_cp(monkeypatch):
    mod = importlib.import_module("repro_torch.methods.cp_als")
    real = mod._iteration

    def stuck(ws, factors, grams, norm_x_sq, **kw):
        _, _, lam, fit = real(ws, factors, grams, norm_x_sq, **kw)
        return tuple(factors), tuple(grams), lam, fit

    monkeypatch.setattr(mod, "_iteration", stuck)


def _stuck_tucker(monkeypatch):
    mod = importlib.import_module("repro_torch.methods.tucker_hooi")
    real = mod._hooi_mode

    def stuck(ws_n, factors, *, mode, **kw):
        _, y = real(ws_n, factors, mode=mode, **kw)
        return factors[mode], y

    monkeypatch.setattr(mod, "_hooi_mode", stuck)


def _stuck_tucker_first_mode(monkeypatch):
    """Mode 0's factor left as it was, every other mode sound: a fault the
    last mode's step alone cannot see."""
    mod = importlib.import_module("repro_torch.methods.tucker_hooi")
    real = mod._hooi_mode

    def stuck(ws_n, factors, *, mode, **kw):
        u, y = real(ws_n, factors, mode=mode, **kw)
        return (factors[mode] if mode == 0 else u), y

    monkeypatch.setattr(mod, "_hooi_mode", stuck)


def _half(real, modes=None):
    """``real``'s rows at odd positions left out and the rest doubled, in
    the products of ``modes`` (all when None); the mode is the third
    argument, as the drivers pass it."""
    def half(ws, factors, mode, **kw):
        out = real(ws, factors, mode, **kw)
        if modes is not None and mode not in modes:
            return out
        out = out.clone()
        out[1::2] = 0.0
        out[0::2] *= 2.0
        return out
    return half


def _half_cp(monkeypatch, modes=None):
    from repro_torch.core import cpals as mod

    monkeypatch.setattr(mod, "mttkrp", _half(mod.mttkrp, modes))


def _half_tucker(monkeypatch, modes=None):
    mod = importlib.import_module("repro_torch.methods.tucker_hooi")
    monkeypatch.setattr(mod, "ttmc", _half(mod.ttmc, modes))


def _altered(monkeypatch):
    import repro_torch.methods as mod

    real = mod.fit

    def altered(*args, **kw):
        dec = real(*args, **kw)
        first = dec.factors[0].clone()
        first[:, 0] = 0.0
        return dataclasses.replace(dec, factors=(first,) + dec.factors[1:])

    monkeypatch.setattr(mod, "fit", altered)


CP_FAULTS = {
    "state_unchanged": _stuck_cp, "half_left_out": _half_cp,
    "half_left_out_mode0": lambda mp: _half_cp(mp, modes=(0,)),
    "answer_altered": _altered}
TUCKER_FAULTS = {
    "state_unchanged": _stuck_tucker,
    "state_unchanged_mode0": _stuck_tucker_first_mode,
    "half_left_out": _half_tucker,
    "half_left_out_mode0": lambda mp: _half_tucker(mp, modes=(0,)),
    "half_left_out_mode1": lambda mp: _half_tucker(mp, modes=(1,)),
    "answer_altered": _altered}
FAULTS = {"yelp-uniform.cp-restarts": CP_FAULTS,
          "yelp-uniform.tucker-restarts": TUCKER_FAULTS}


@pytest.mark.parametrize("name,fault", [
    (n, f) for n, faults in FAULTS.items() for f in faults])
def test_fault_is_not_correct(monkeypatch, name, fault):
    FAULTS[name][fault](monkeypatch)
    result, _ = run(name, size=TINY)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
