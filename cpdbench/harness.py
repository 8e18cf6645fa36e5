"""One run of one cell: set-up, the measured window or the traced passes,
the comparison with the reference, and the result line.

A cell is a ``workloads`` entry of ``BENCHMARK.json``: a configuration (a
tensor, the program's ``impl``) under a traffic mix (a closed loop of fits
by one client, each from new initial factors).  The program under test is
``repro_torch``: ``ingest`` once, then ``methods.fit`` on the handle.
Everything a cell needs is found by name through :mod:`cpdbench.plugins`.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import platform
import random
import subprocess
import sys
import time

import torch

from cpdbench import devtrace, generate, plugins, reference

# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# seconds to wait for nvidia-smi
SMI_TIMEOUT_S = 30


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    checks: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, manifest: dict | None = None) -> Cell:
    """The cell named ``workload`` with its configuration, mix, comparison
    and the metrics it reports."""
    if manifest is None:
        manifest = plugins.load_json(plugins.ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        cfg=plugins.load_json(plugins.ROOT / entry["file"]),
        mix=plugins.data("traffic", w["traffic"]),
        checks=plugins.data("cells", workload),
        end_to_end=[m for m in manifest["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"]
                   if _applies(m, workload)])


class Device:
    """The card a run uses (or, in a rehearsal, the CPU)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def free(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()

    @property
    def kind(self) -> str:
        return torch.cuda.get_device_name() if self.cuda else "cpu"

    @property
    def platform(self) -> str:
        return "gpu" if self.cuda else "cpu"


class Program:
    """The system under test: ``repro_torch``'s ingest and ``fit``."""

    def __init__(self, cfg: dict, mix: dict):
        from repro_torch.core.coo import SparseTensor
        from repro_torch.ingest import ingest
        from repro_torch.methods import DecompState, fit

        self._sparse, self._ingest = SparseTensor, ingest
        self._state, self._fit = DecompState, fit
        self.cfg, self.mix = cfg, mix
        self.rank = (tuple(mix["rank"]) if isinstance(mix["rank"], list)
                     else int(mix["rank"]))

    def ingest(self, inds, vals, device):
        t = self._sparse(inds, vals, self.cfg["dims"], int(vals.shape[0]),
                         device=device)
        return self._ingest(t, reorder="identity")

    def fit(self, handle, init, timers=None, states=None):
        """One fit from ``init`` (an iteration-0 state): the decomposition
        and its fit as a float.  Where ``states`` is a list, the factors at
        the end of each sweep are appended to it, in the original labels,
        through the methods' ``checkpoint_cb``."""
        like = init[0]
        zero = torch.zeros((), dtype=like.dtype, device=like.device)
        aux = {k: torch.ones(init[0].shape[1], dtype=like.dtype,
                             device=like.device)
               for k in self.mix.get("ones_aux", ())}
        state = self._state(tuple(init), aux, zero, zero,
                            torch.tensor(0, dtype=torch.int32))
        dec = self._fit(handle, self.rank, method=self.mix["method"],
                        niters=int(self.mix["niters"]),
                        tol=float(self.mix["tol"]), impl=self.cfg["impl"],
                        state=state, timers=timers,
                        checkpoint_cb=None if states is None else (
                            lambda s: states.append(
                                handle.restore_factors(s.factors))))
        return dec, float(dec.fit)


class Sample:
    """A reservoir of the fits to compare, drawn from the seed: at most
    ``k`` kept at a time, each fit with the same chance."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(generate.stream_seed(seed, 1 << 40))
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=SMI_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {type(e).__name__}"
    return out.stdout.strip() or out.stderr.strip()


def _emit(obj: dict, out) -> None:
    out.write(json.dumps(obj) + "\n")
    out.flush()


def loaded_top_level(names) -> list[str]:
    """Those of ``names`` that are the top-level name (the part before the
    first dot, whole) of a loaded module."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(names))


class Runner:
    """One run: build it, then :meth:`run`."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t0: float, out=None, err=None,
                 forbidden=FORBIDDEN_MODULES):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = bool(trace)
        self.forbidden = tuple(forbidden)
        self.dev = Device(device)
        self.t0 = t0
        self.out = out if out is not None else sys.stdout
        self.err = err if err is not None else sys.stderr
        self.sample = Sample(int(cell.checks["checked_fits"]), self.seed)
        self.n_fits = 0
        self.failed = 0
        self.record: dict = {"workload": cell.name, "cfg": cell.cfg,
                             "mix": cell.mix}
        self.method = reference.METHODS[cell.mix["method"]]

    def _states(self):
        """A list for the fit's state at the end of each sweep, where the
        method's judge reads them."""
        return [] if self.method["states"] else None

    # -- fits --------------------------------------------------------------
    def _one_fit(self, program, handle, timers=None) -> None:
        i = self.n_fits
        init = generate.initial_factors(self.cell.cfg, self.cell.mix,
                                        self.seed, generate.FIT_STREAM + i,
                                        self.dev.device)
        digest = generate.fingerprint(init)
        states = self._states()
        dec, value = program.fit(handle, init, timers=timers, states=states)
        if not math.isfinite(value):
            self.failed += 1
        self.sample.offer((i, dec, value, digest, states))
        self.n_fits += 1

    def _fits_for(self, program, handle, seconds: float) -> tuple[int, float]:
        """Fits back to back until ``seconds`` have passed; the window ends
        at the end of the last fit."""
        before = [g["collections"] for g in gc.get_stats()]
        start = time.perf_counter()
        ends = []
        while True:
            self._one_fit(program, handle)
            ends.append(time.perf_counter())
            if ends[-1] - start >= seconds:
                break
        each = sorted(b - a for a, b in zip([start] + ends, ends))
        self.record["fit_spread_s"] = {
            "min": each[0], "median": each[len(each) // 2],
            "max": each[-1], "collections": [
                g["collections"] - b for g, b in zip(gc.get_stats(), before)]}
        return len(ends), ends[-1] - start

    def _fits(self, program, handle, n: int, timers=None) -> float:
        self.dev.sync()
        start = time.perf_counter()
        for _ in range(n):
            self._one_fit(program, handle, timers=timers)
        self.dev.sync()
        return time.perf_counter() - start

    # -- the run -----------------------------------------------------------
    def run(self) -> dict | None:
        """Set up, measure, compare; print the result line and return it.
        Returns None, printing no result, if a forbidden module was
        loaded."""
        cell, dev, rec = self.cell, self.dev, self.record
        parts = {}
        mark = time.perf_counter()
        parts["process_to_harness_s"] = mark - self.t0
        if dev.cuda:
            torch.cuda.init()
            torch.zeros(1, device=dev.device)
            dev.sync()
        parts["cuda_init_s"] = time.perf_counter() - mark

        mark = time.perf_counter()
        inds, vals = generate.sparse_tensor(cell.cfg, self.seed, dev.device)
        dev.sync()
        gen_peak = dev.peak()
        dev.free()
        dev.reset_peak()
        rec["nnz"] = int(vals.shape[0])
        rec["dims"] = [int(d) for d in cell.cfg["dims"]]
        parts["generate_s"] = time.perf_counter() - mark

        mark = time.perf_counter()
        program = Program(cell.cfg, cell.mix)
        handle = program.ingest(inds, vals, dev.device)
        del inds, vals
        dev.sync()
        parts["ingest_s"] = time.perf_counter() - mark

        mark = time.perf_counter()
        warm = {}
        init = generate.initial_factors(cell.cfg, cell.mix, self.seed,
                                        generate.WARMUP_STREAM, dev.device)
        program.fit(handle, init, timers=warm, states=self._states())
        del init
        dev.sync()
        parts["warmup_fit_s"] = time.perf_counter() - mark
        parts["warmup_sort_s"] = warm.get("sort", 0.0)
        rec["setup"] = parts
        rec["warmup_timers"] = warm
        # what set-up left is moved out of the collector's reach, so that
        # the window's collections do not walk it
        gc.collect()
        gc.freeze()
        rec["setup_s"] = time.perf_counter() - self.t0
        if self.trace:
            self._traced(program, handle)
        else:
            n, wall = self._fits_for(program, handle, self.seconds)
            rec["window"] = {"fits": n, "wall_s": wall}
            _emit({"window": rec["window"],
                   "fit_spread_s": rec["fit_spread_s"]}, self.out)
        dev.sync()
        gc.unfreeze()
        rec["peak_bytes"] = dev.peak()
        memory_peak = max(gen_peak, rec["peak_bytes"])
        _emit({"setup_parts": parts, "versions": {
            "python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda}, "card": dev.kind,
            "nvidia_smi": _smi() if dev.cuda else "no card"}, self.out)

        found = loaded_top_level(self.forbidden)
        if found:
            self.err.write(f"forbidden modules loaded: {found}\n")
            self.err.flush()
            return None

        del handle, program
        dev.free()
        mark = time.perf_counter()
        checks = self._compare()
        rec["reference_s"] = time.perf_counter() - mark
        _emit({"reference_s": rec["reference_s"],
               "readings": self.readings}, self.out)

        device = {"platform": dev.platform, "kind": dev.kind, "count": 1,
                  "memory_peak_bytes": memory_peak}
        result = {"correct": self._correct(checks),
                  "attempted": self.n_fits, "failed": self.failed,
                  "metrics": self._metrics(), "device": device}
        if self.trace:
            prof = rec["profile"]
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
        result["checks"] = checks
        for name, c in checks.items():
            self.err.write(f"check {name} {c['value']!r} limit "
                           f"{c['limit']!r}\n")
        self.err.flush()
        _emit(result, self.out)
        return result

    def _traced(self, program, handle) -> None:
        """The traced run's passes: plain fits (the fit's wall), fits under
        the profiler (busy time, breakdown), fits with the methods'
        synchronised routine timers (the paper's Table III split)."""
        mix, rec = self.cell.mix, self.record
        n = int(mix["trace_plain_fits"])
        rec["plain"] = {"fits": n, "wall_s": self._fits(program, handle, n)}
        n = int(mix["trace_profiled_fits"])
        rec["profile"] = devtrace.profile(
            lambda: self._fits(program, handle, n), self.dev.sync)
        rec["profile"]["fits"] = n
        n = int(mix["trace_timed_fits"])
        timers: dict = {}
        self._fits(program, handle, n, timers=timers)
        rec["timers"] = timers
        rec["timed_fits"] = n

    def _metrics(self) -> dict:
        rec = self.record
        rec["device_kind"] = self.dev.kind
        rec["peak"] = plugins.peak_for(self.dev.kind)
        wanted = self.cell.per_layer if self.trace else self.cell.end_to_end
        out = {}
        for m in wanted:
            value = plugins.metric_reader(m["name"]).read(rec)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    # -- the comparison ----------------------------------------------------
    def _compare(self) -> dict:
        """Each number the cell compares, as the worst over the sampled
        fits, beside its limit."""
        cell, dev, method = self.cell, self.dev, self.method
        limits = cell.checks["limits"]
        inds, vals = generate.sparse_tensor(cell.cfg, self.seed, dev.device)
        worst = {name: 0.0 for name in limits}
        self.readings = []
        for i, dec, value, digest, states in self.sample.kept:
            init = generate.initial_factors(
                cell.cfg, cell.mix, self.seed, generate.FIT_STREAM + i,
                dev.device)
            got = {f: getattr(dec, f) for f in method["fields"]}
            got.update(fit=value, states=states)
            readings = method["judge"](inds, vals, init, cell.mix, got,
                                       wanted=limits)
            readings["init_gap"] = float(torch.max(torch.abs(
                generate.fingerprint(init) - digest)))
            self.readings.append(dict(readings, fit_index=i))
            for name in worst:
                # a reading that is not a number stays, and fails
                if not readings[name] <= worst[name]:
                    worst[name] = readings[name]
        return {name: {"value": worst[name], "limit": limit}
                for name, limit in limits.items()}

    def _correct(self, checks: dict) -> bool:
        return (self.failed == 0 and len(self.sample.kept) > 0
                and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                        for c in checks.values()))
