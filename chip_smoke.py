#!/usr/bin/env python3
"""Drive the PyTorch port's CP-ALS, Tucker, ingest, HALS, checkpoint and
streaming paths on one CUDA card and check them.

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel), print each kernel's registers, stack and
   spills as ptxas reports them, and read the card's name and power limit,
   printed at the end, beside the numbers.
2. K1, MTTKRP: on each mode of the full-size yelp tensor (paper Table I
   shape, drawn on the card from the seed) at rank 35, the kernel against
   its plain version, in float32 (rtol/atol 1e-4: atomics change the order
   of summation) and in bfloat16 (5e-2).  Times, median of CUDA-event-timed
   calls after warm-up, beside the least time the card could take, and the
   factor-row bytes the kernel gathers from L2 and their rate.
3. K2, SYRK: at the three factor shapes, against its plain version (rtol
   1e-4, atol 1e-3), and beside ``torch.matmul(a.T, a)`` as the library's
   yardstick (timed here only; the port never calls it), each timed two
   ways: the median of single calls (the kernel table's ``ms``) and the
   time per launch over 100 back-to-back calls between one pair of CUDA
   events; and the device time of their kernels, from torch.profiler.
   Then the steady-state time of one mode's epilogue (the work after its
   MTTKRP).
4. K3, MTTKRP on the linearized workspace: ``build_linearized`` of the
   full yelp tensor with sort mode 0 (its row field straddles the two
   32-bit words) and sort mode 1 (its row field lies in the high word),
   the host build timed.  On each sort mode the kernel against its plain
   version (float32 at 1e-4, bfloat16 at 5e-2) and against K1 on that
   mode's CSF (1e-4: the same function on another layout), timed beside
   its bound (12 B a stored entry, the gathered factors, the output) and
   its L2 gathers.  Then the off-sort kernel on every other mode of each
   sort mode (sort mode 1 puts mode 0's field across the words), held to
   the same plain version and K1 at the same limits, timed beside its
   bound, its L2 gathers and its atomic bytes (runs of equal rows x width
   x 4 B, each run ending where the row changes or a warp's range ends)
   and their rate.
5. The main path: ``repro_torch.methods.fit(t, 35, method="cp_als",
   impl="cuda", niters=20, timers=...)`` on yelp, with every launch count
   set to 0 just before and read just after: MTTKRP must launch 3 modes x
   20 iterations = 60 times, K3 and SYRK none (the driver keeps ``A.T @ A``
   as the reference's does).  Against the plain ``impl="segment"`` run from
   the same initial factors, its fit must agree within 1e-5, and lambda and
   each factor within a relative 3e-2: the kernel's float atomics reorder
   its sums, and the ALS solves against the Grams' hadamard product
   amplify that to a relative 1e-3 to 7e-3 already.
6. The linearized path: the same fit with ``impl="linearized_cuda"`` from
   the same state, the counts set to 0 just before: K3 launches 20 times
   (the sort mode, once an iteration) and the off-sort kernel 40 (modes 1
   and 2), K1 and SYRK none; held to ``segment`` as in phase 5.  Its
   routine times print beside the CSF fit's.
7. The measured planner: ``plan_decomposition(t, "auto", rank=35,
   calibrate=True, autotune=<temporary store>)`` prints each mode's
   measured ms per candidate and the winner; a second plan on the same
   store (its content key and stats pass timed apart) must be ``"measured-cached"`` on every mode with the same impls,
   3 store hits and no timing run; a 20-iteration fit with that plan is
   held to ``segment``'s fit within 1e-5.
8. The Gram entry point, SYRK's path: ``gram(a, impl="cuda")`` on the
   fitted factors, with the counts set to 0 just before; 3 launches, and
   the model's norm from those Grams within 1e-4 of the plain Grams'.
9. The TTMc kernels at Kronecker width: K1-TTMc on each mode's CSF of the
   yelp tensor, K3-TTMc on sort modes 0 and 1 and the off-sort TTMc on
   every other mode of each, at Tucker ranks (16, 16, 16) (W = 256), each
   against its plain version (float32 at 1e-4, bfloat16 at 5e-2), the
   linearized ones also against K1-TTMc on the same mode's CSF, timed
   beside their bounds and beside the factor rows each gathers from L2 and
   their rate (the off-sort one also beside its atomic bytes and their
   rate); then one thin SVD of mode 2's Y (75 000 x 256), the library call
   the fit makes after each TTMc.
10. The Tucker path: ``fit(t, (16, 16, 16), method="tucker_hooi",
   impl="cuda", niters=8, timers=...)`` with every count set to 0 just
   before: K1-TTMc launches 3 x 8 = 24 times, nothing else.  Held to the
   plain ``impl="segment"`` fit from the same orthonormal state, which
   must launch no kernel at all (so it stays independent of them): the fit
   within 1e-5, ``values_at`` on 100 000 stored coordinates within a
   relative 1e-3 (2-norm of the difference over that of the values), and
   each mode's subspace ``||U U^T - U' U'^T||_F / sqrt(R) <= 1e-3``
   (computed in float64 from U^T U, U'^T U' and U^T U').  The gap between
   sigma_R and sigma_{R+1} of each mode's final Y is printed beside it.
11. The linearized Tucker path: the same fit with
   ``impl="linearized_cuda"``: K3-TTMc launches 8 times (sort mode 0) and
   the off-sort TTMc 16 (modes 1 and 2), nothing else; held to
   ``segment`` as in phase 10.
12. The ingested path, in a temporary directory: ``write_tnsb`` of the
   yelp tensor and ``read_tnsb`` back (equal, bit for bit); a cold
   ``ingest(path, reorder="degree_sort", cache=...)`` (3 CSF builds and 1
   linearized build) and a warm one, which must be a cache hit and build
   nothing (the builds are counted at ``core.csf.build_csf`` and
   ``core.linearized.build_linearized``); ``ing.plan("auto", rank=35,
   calibrate=True)`` twice, the second from the cache's autotune store (3
   hits, no timing run).  Then ``fit(ing, 35, method="cp_nn_hals",
   niters=20)`` with ``impl="segment"``, ``"cuda"`` (60 K1 launches) and
   ``"linearized_cuda"`` (20 K3 + 40 off-sort), from one nonnegative
   state, the kernel fits held to ``segment``'s at the CP limits and every
   factor >= 0; ``fit(ing, 35, impl="cuda", niters=20)`` on the warm handle
   (no Sort), its factors back in the tensor's labels and held to phase
   5's ``segment`` fit; and a ``CheckpointManager`` resume: 10 iterations
   saved at each step, a fresh manager restores the newest onto the card,
   and a new fit resumes it to 20, held to the uninterrupted 20 at the CP
   limits.  Each step's seconds print beside the card's name and power
   limit.
13. Streaming: ``fit(path, 35, method="cp_als_streaming", niters=5)`` from
   the ``.tnsb`` (chunks of 2^20 entries moved to the card one at a time,
   ``decay=1``) against the batch ``segment`` fit from the same state:
   fits within 1e-3.
14. One JSON line of kernel numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RANK = 35
NITERS = 20
TUCKER_RANKS = (16, 16, 16)
TUCKER_NITERS = 8
STREAM_NITERS = 5
# NVIDIA H100 SXM data sheet (dense, no sparsity) at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for the work, and whether bytes or operations set
    it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def totals() -> dict[str, float]:
    """A kernel's times and bound summed over the calls the main path makes,
    and its largest error over every call checked."""
    return dict.fromkeys(("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
                          "max_abs_err"), 0.0)


def add_times(acc, ms: float, plain_ms: float, nbytes: float,
              ops_count: float) -> None:
    """Add one call's times and bound to a kernel's totals."""
    acc["ms"] += ms
    acc["plain_ms"] += plain_ms
    acc["bound_ms"] += bound(nbytes, ops_count)[0]
    acc["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
    acc["ops_ms"] += ops_count / FP32_FLOP_PER_S * 1e3


def kernel_entry(name: str, source: str, replaces: str, launches: int, acc,
                 **extra) -> dict:
    """One kernel's object of the ``{"kernels": ...}`` line."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, **extra, "launches": launches,
            "max_abs_err": acc["max_abs_err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                         else "operations"),
            "library_ms": acc.get("library_ms")}


def time_ms(torch, fn, *, warmup: int = 3, reps: int = 15) -> float:
    """Median of CUDA-event-timed calls of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_per_launch_ms(torch, fn, *, warmup: int = 3,
                       launches: int = 100) -> float:
    """Time of one call of ``fn`` over ``launches`` back-to-back calls
    between one pair of CUDA events, after ``warmup`` calls: the host's
    per-call work overlaps the card's, as in a loop of calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def device_us(torch, fn, *, calls: int = 20) -> float | None:
    """Device time of one call of ``fn`` in microseconds: its kernels'
    device time summed over ``calls`` calls traced by torch.profiler, over
    ``calls``; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total / calls if total > 0 else None


def gathered_bytes(ids, row_bytes) -> int:
    """Bytes of factor rows a row-segmented kernel gathers from L2 in one
    call, counted in 32-B sectors: each stored entry (padding included)
    reads the whole row of each other factor, the warp's lanes together, and
    the row of id ``i`` in a factor of ``b``-byte rows starts at byte
    ``i * b``, so it touches the sectors ``i * b // 32`` through
    ``(i * b + b - 1) // 32``.  ``ids``: per other factor, the (pnnz,) row
    ids the kernel reads; ``row_bytes``: that factor's row stride in
    bytes."""
    sectors = 0
    for i, b in zip(ids, row_bytes):
        first = i.long() * b
        sectors += int(((first + b - 1) // 32 - first // 32 + 1).sum())
    return 32 * sectors


def atomic_runs(torch, rows, segment: int) -> int:
    """Runs of equal rows the off-sort kernel adds to its output with
    atomics in one call: a run ends where the row changes or where a warp's
    range of ``segment`` stored entries ends.  ``rows``: the (pnnz,) target
    rows the kernel decodes, padding included."""
    new = torch.ones_like(rows, dtype=torch.bool)
    new[1:] = rows[1:] != rows[:-1]
    new[::segment] = True
    return int(new.sum())


def build_lines(log: str) -> list[tuple[str, int, int, int]]:
    """(mangled kernel name, registers, stack bytes, spill bytes) for each
    entry function of ptxas's ``-v`` report."""
    rows, name, stack, spill = [], "", 0, 0
    for line in log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            stack, spill = nums[0], nums[1] + nums[2]
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            rows.append((name, regs, stack, spill))
            name, stack, spill = "", 0, 0
    return rows


def demangle(names: list[str]) -> list[str]:
    """The kernels' names through one c++filt, each cut to its template;
    the mangled names where c++filt is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    if len(out) != len(names):
        return names
    return [o.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for o in out]


def max_err(torch, got, want, *, rtol: float, atol: float, what: str) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=what)
    return float((got - want).abs().max())


def rel_diffs(torch, got, want) -> tuple[float, list[float]]:
    """Largest relative difference of lambda, and the relative Frobenius
    difference of each factor, between two decompositions."""
    lmbda = float(((got.lmbda - want.lmbda).abs()
                   / want.lmbda.abs().clamp_min(1e-30)).max())
    return lmbda, [float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                   for a, b in zip(got.factors, want.factors)]


def subspace_gap(torch, u, v) -> float:
    """||U U^T - V V^T||_F / sqrt(R) from the R x R products alone (the
    n x n ones would not fit), in float64: the squared norm is
    ||U^T U||^2 + ||V^T V||^2 - 2 ||U^T V||^2 for any U, V."""
    u, v = u.double(), v.double()
    sq = (torch.linalg.norm(u.T @ u) ** 2 + torch.linalg.norm(v.T @ v) ** 2
          - 2 * torch.linalg.norm(u.T @ v) ** 2)
    return math.sqrt(max(0.0, float(sq)) / u.shape[1])


def main() -> int:
    start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import (build_all_modes, build_linearized,
                                  init_factors, paper_dataset)
    from repro_torch.core.cpals import (ROUTINES_FUSED, CPALSState,
                                        _mode_epilogue)
    from repro_torch.core.gram import gram, kruskal_norm_sq
    from repro_torch.kernels import (_build, linearized_cuda, mttkrp_cuda, ops,
                                     ref, syrk_cuda)
    from repro_torch.methods import fit, make_state
    from repro_torch.methods.tucker_hooi import _init_orthonormal
    from repro_torch.core.csf import DEFAULT_BLOCK, DEFAULT_ROW_TILE
    from repro_torch.ingest import content_key
    from repro_torch.plan import AutotuneStore, plan_decomposition, tensor_stats

    counters = {"mttkrp": mttkrp_cuda.mttkrp, "syrk": syrk_cuda.syrk,
                "mttkrp_lin": linearized_cuda.mttkrp,
                "mttkrp_off_sort": linearized_cuda.mttkrp_off_sort,
                "ttmc": mttkrp_cuda.ttmc, "ttmc_lin": linearized_cuda.ttmc,
                "ttmc_off_sort": linearized_cuda.ttmc_off_sort}
    none = dict.fromkeys(counters, 0)

    def zero_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict[str, int]:
        return {name: fn.launches for name, fn in counters.items()}

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] kernels built in {build_s:.3f} s")
    rows = [(lib, *row) for lib, log in _build.BUILD_LOG.items()
            for row in build_lines(log)]
    spilled = []
    for (lib, _, regs, stack, spill), kernel in zip(
            rows, demangle([row[1] for row in rows])):
        print(f"[build] {lib}: {regs} registers, {stack} B stack, "
              f"{spill} B spill: {kernel}")
        if spill:
            spilled.append(kernel)
    if _build.BUILD_LOG:
        print(f"[build] kernels that spill: {spilled if spilled else 'none'}")
    else:
        print("[build] every library was built before this run: no ptxas "
              "report")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # --- 2. K1: MTTKRP on full-size yelp ------------------------------------
    t0 = time.perf_counter()
    t = paper_dataset("yelp", args.seed, scale=1.0, device=dev)
    csfs = build_all_modes(t)
    torch.cuda.synchronize()
    print(f"[data] yelp dims={t.dims} nnz={t.nnz} built+sorted in "
          f"{time.perf_counter() - t0:.3f} s; (rows, padded nnz, blocks) "
          f"per mode: "
          + ", ".join(f"({c.num_rows}, {c.padded_nnz}, {c.num_blocks})"
                      for c in csfs))
    factors = init_factors(t.dims, RANK, args.seed + 1, device=dev)
    k1 = totals()
    for csf in csfs:
        got = ops.mttkrp(csf, factors)
        want = ref.mttkrp_ref(csf, factors)
        err = max_err(torch, got, want, rtol=1e-4, atol=1e-4,
                      what=f"K1 mode {csf.mode} float32")
        fb = tuple(a.bfloat16() for a in factors)
        err_bf16 = max_err(torch, ops.mttkrp(csf, fb),
                           ref.mttkrp_ref(csf, fb).bfloat16(), rtol=5e-2,
                           atol=5e-2, what=f"K1 mode {csf.mode} bfloat16")
        ms = time_ms(torch, lambda: ops.mttkrp(csf, factors))
        plain_ms = time_ms(torch, lambda: ref.mttkrp_ref(csf, factors))
        n_other = csf.order - 1
        nbytes = (csf.padded_nnz * (4 + 4 * n_other + 4)
                  + sum(csf.dims[m] * RANK * 4 for m in csf.other_modes)
                  + csf.num_rows * RANK * 4)
        ops_count = csf.padded_nnz * RANK * (n_other + 1)
        b_ms, b_by = bound(nbytes, ops_count)
        gathered = gathered_bytes(csf.other_ids.unbind(1),
                                  [RANK * 4] * n_other)
        print(f"[K1] mode {csf.mode} err f32={err:.3e} bf16={err_bf16:.3e}"
              f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}, {nbytes / 1e6:.1f} MB); L2 gathers "
              f"{gathered / 1e9:.3f} GB at {gathered / ms / 1e6:.1f} GB/s; "
              f"{mttkrp_cuda.mttkrp_geometry(csf.padded_nnz, RANK)}")
        add_times(k1, ms, plain_ms, nbytes, ops_count)
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
    del got, want

    # --- 3. K2: SYRK at the factor shapes ----------------------------------
    k2 = dict(totals(), library_ms=0.0)
    for m, a in enumerate(factors):
        err = max_err(torch, ops.syrk(a), ref.syrk_ref(a), rtol=1e-4,
                      atol=1e-3, what=f"K2 factor {m}")
        ms = time_ms(torch, lambda: ops.syrk(a))
        plain_ms = time_ms(torch, lambda: ref.syrk_ref(a))
        library_ms = time_ms(torch, lambda: torch.matmul(a.T, a))
        run_ms = time_per_launch_ms(torch, lambda: ops.syrk(a))
        run_library_ms = time_per_launch_ms(torch,
                                            lambda: torch.matmul(a.T, a))
        dev_us, dev_library_us = (
            device_us(torch, f) for f in (lambda: ops.syrk(a),
                                          lambda: torch.matmul(a.T, a)))
        rows = a.shape[0]
        nbytes = rows * RANK * 4 + RANK * RANK * 4
        ops_count = 2 * rows * RANK * RANK
        b_ms, b_by = bound(nbytes, ops_count)
        print(f"[K2] {rows}x{RANK} err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}); per launch of 100 "
              f"back-to-back: ms={run_ms:.4f} library_ms="
              f"{run_library_ms:.4f}; device us a call (torch.profiler): "
              f"{dev_us if dev_us else 'not measured'} library "
              f"{dev_library_us if dev_library_us else 'not measured'}")
        add_times(k2, ms, plain_ms, nbytes, ops_count)
        k2["library_ms"] += library_ms
        k2["max_abs_err"] = max(k2["max_abs_err"], err)

    # the steady-state epilogue per mode update, apart from the one-off
    # library set-up that the fit's first iteration pays
    grams = tuple(gram(a) for a in factors)
    norm_x_sq = torch.sum(t.vals.float() ** 2)
    epilogue_ms = []
    for csf in csfs:
        m_mat = ops.mttkrp(csf, factors)
        epilogue_ms.append(time_ms(torch, lambda: _mode_epilogue(
            m_mat, factors, grams, norm_x_sq, mode=csf.mode, norm_kind="2",
            with_fit=csf.mode == t.order - 1)))
    print("[epilogue] ms per mode: "
          + " ".join(f"{ms:.4f}" for ms in epilogue_ms))

    # --- 4. K3: MTTKRP on the linearized workspace ------------------------
    def lin_mttkrp_bound(lin, mode: int):
        """Bytes, operations and bound of one linearized MTTKRP call on
        ``mode``: 12 B a stored entry, the other factors, the output."""
        nbytes = (lin.padded_nnz * 12
                  + sum(t.dims[m] * RANK * 4 for m in range(t.order)
                        if m != mode)
                  + t.dims[mode] * RANK * 4)
        ops_count = lin.padded_nnz * RANK * t.order
        return nbytes, ops_count, *bound(nbytes, ops_count)

    def lin_gathers(lin, mode: int, ranks) -> int:
        """L2 sector bytes of the factor rows a linearized call on ``mode``
        gathers, the factors of ``ranks`` in float32."""
        others = [m for m in range(t.order) if m != mode]
        return gathered_bytes([lin.decode(m) for m in others],
                              [ranks[m] * 4 for m in others])

    k3, k3off = totals(), totals()
    lins = {}  # kept for the TTMc phase
    for sm in (0, 1):
        t0 = time.perf_counter()
        lin = build_linearized(t, sort_mode=sm)
        torch.cuda.synchronize()
        lin_s = time.perf_counter() - t0
        print(f"[K3] sort mode {sm}: widths={lin.widths} "
              f"offsets={lin.offsets} padded nnz={lin.padded_nnz} "
              f"blocks={lin.num_blocks} host build {lin_s:.3f} s")
        got = ops.mttkrp_lin(lin, factors, sm)
        err = max_err(torch, got, ref.mttkrp_lin_ref(lin, factors, sm),
                      rtol=1e-4, atol=1e-4, what=f"K3 sort mode {sm} float32")
        err_k1 = max_err(torch, got, ops.mttkrp(csfs[sm], factors),
                         rtol=1e-4, atol=1e-4, what=f"K3 vs K1 mode {sm}")
        fb = tuple(a.bfloat16() for a in factors)
        err_bf16 = max_err(torch, ops.mttkrp_lin(lin, fb, sm),
                           ref.mttkrp_lin_ref(lin, fb, sm).bfloat16(),
                           rtol=5e-2, atol=5e-2,
                           what=f"K3 sort mode {sm} bfloat16")
        ms = time_ms(torch, lambda: ops.mttkrp_lin(lin, factors, sm))
        plain_ms = time_ms(torch,
                           lambda: ref.mttkrp_lin_ref(lin, factors, sm))
        nbytes, ops_count, b_ms, b_by = lin_mttkrp_bound(lin, sm)
        gathered = lin_gathers(lin, sm, [RANK] * t.order)
        print(f"[K3] sort mode {sm} err f32={err:.3e} vs K1={err_k1:.3e} "
              f"bf16={err_bf16:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB); L2 "
              f"gathers {gathered / 1e9:.3f} GB at "
              f"{gathered / ms / 1e6:.1f} GB/s")
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        if sm == 0:  # the sort mode the linearized fit runs
            add_times(k3, ms, plain_ms, nbytes, ops_count)
        for tm in (m for m in range(t.order) if m != sm):
            got = ops.mttkrp_lin(lin, factors, tm)
            what = f"off-sort MTTKRP sort mode {sm} mode {tm}"
            err = max_err(torch, got, ref.mttkrp_lin_ref(lin, factors, tm),
                          rtol=1e-4, atol=1e-4, what=f"{what} float32")
            err_k1 = max_err(torch, got, ops.mttkrp(csfs[tm], factors),
                             rtol=1e-4, atol=1e-4, what=f"{what} vs K1")
            err_bf16 = max_err(torch, ops.mttkrp_lin(lin, fb, tm),
                               ref.mttkrp_lin_ref(lin, fb, tm).bfloat16(),
                               rtol=5e-2, atol=5e-2, what=f"{what} bfloat16")
            ms = time_ms(torch, lambda: ops.mttkrp_lin(lin, factors, tm))
            plain_ms = time_ms(torch,
                               lambda: ref.mttkrp_lin_ref(lin, factors, tm))
            nbytes, ops_count, b_ms, b_by = lin_mttkrp_bound(lin, tm)
            gathered = lin_gathers(lin, tm, [RANK] * t.order)
            red = atomic_runs(torch, lin.decode(tm), mttkrp_cuda.SEGMENT)
            print(f"[K3-off] sort mode {sm} mode {tm} err f32={err:.3e} vs "
                  f"K1={err_k1:.3e} bf16={err_bf16:.3e} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
                  f"{nbytes / 1e6:.1f} MB); L2 gathers {gathered / 1e9:.3f} "
                  f"GB at {gathered / ms / 1e6:.1f} GB/s; atomics {red} runs"
                  f" x {RANK} x 4 B = {red * RANK * 4 / 1e9:.3f} GB at "
                  f"{red * RANK * 4 / ms / 1e6:.1f} GB/s")
            k3off["max_abs_err"] = max(k3off["max_abs_err"], err)
            if sm == 0:  # the modes the linearized fit runs off the sort
                add_times(k3off, ms, plain_ms, nbytes, ops_count)
        lins[sm] = lin
        del lin, got

    # --- 5. the main path ---------------------------------------------------
    init = init_factors(t.dims, RANK, args.seed + 2, device=dev)
    zero = torch.tensor(0.0, device=dev)
    state = CPALSState(init, torch.ones(RANK, device=dev), zero, zero,
                       torch.tensor(0, dtype=torch.int32))
    def timed_fit(impl: str, want_launches: dict[str, int]):
        """One 20-iteration timed fit from ``state``, launch counts set to
        0 just before and checked just after."""
        timers: dict[str, float] = {}
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = fit(t, RANK, method="cp_als", impl=impl, niters=NITERS,
                  timers=timers, fused_epilogue=True, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(f"[fit] impl={impl} fit={float(dec.fit):.7f} wall_s={wall:.4f}"
              f" launches={counts} "
              + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                         for k in ROUTINES_FUSED))
        if counts != want_launches:
            raise AssertionError(f"impl={impl} launches {counts}, expected "
                                 f"{want_launches}")
        for m, a in enumerate(dec.factors):
            if (tuple(a.shape) != (t.dims[m], RANK)
                    or not torch.isfinite(a).all()):
                raise AssertionError(f"impl={impl} factor {m}: shape "
                                     f"{tuple(a.shape)} or non-finite values")
        return dec, dict(timers, wall=wall), counts

    def check_against_segment(dec, what: str, factors_too: bool = True,
                              want=None, tag: str = "fit",
                              against: str = "segment"):
        """Hold ``dec`` to a plain ``segment`` fit (phase 5's unless
        ``want`` is given; ``against`` names it) at the CP limits."""
        want = dec_seg if want is None else want
        fit_got, fit_seg = float(dec.fit), float(want.fit)
        fit_diff = abs(fit_got - fit_seg)
        lmbda_rel, factor_rel = rel_diffs(torch, dec, want)
        print(f"[{tag}] {what} vs {against} fit={fit_seg:.7f} "
              f"|diff|={fit_diff:.3e} lambda rel={lmbda_rel:.3e} factor rel="
              + " ".join(f"{r:.3e}" for r in factor_rel))
        if not math.isfinite(fit_got) or fit_diff > 1e-5:
            raise AssertionError(f"{what}: fit {fit_got} vs {against} "
                                 f"{fit_seg}")
        if factors_too and (lmbda_rel > 3e-2 or max(factor_rel) > 3e-2):
            raise AssertionError(f"{what}: lambda or a factor differs from "
                                 f"{against}'s by more than a relative 3e-2")

    dec, csf_times, launches = timed_fit(
        "cuda", dict(none, mttkrp=t.order * NITERS))
    dec_seg = fit(t, RANK, method="cp_als", impl="segment", niters=NITERS,
                  state=state)
    check_against_segment(dec, "impl=cuda")

    # --- 6. the linearized path ---------------------------------------------
    dec_lin, lin_times, lin_launches = timed_fit(
        "linearized_cuda", dict(none, mttkrp_lin=NITERS,
                                mttkrp_off_sort=(t.order - 1) * NITERS))
    check_against_segment(dec_lin, "impl=linearized_cuda")
    for name in ("mttkrp_lin", "mttkrp_off_sort"):
        launches[name] = lin_launches[name]
    print("[fit] routine s (csf cuda | linearized_cuda): "
          + " ".join(f"{k}={csf_times[k]:.4f}|{lin_times[k]:.4f}"
                     for k in ("sort", "mttkrp", "epilogue", "wall")))

    # --- 7. the measured planner ------------------------------------------
    # a store hit returns the stored table without timing anything, so 3
    # hits and no new miss on the second plan mean no timing run
    with tempfile.TemporaryDirectory(prefix="autotune-") as root:
        store = AutotuneStore(root)
        t0 = time.perf_counter()
        plan = plan_decomposition(t, "auto", rank=RANK, calibrate=True,
                                  autotune=store)
        print(f"[plan] calibrated in {time.perf_counter() - t0:.3f} s")
        for p in plan.modes:
            print(f"[plan] mode {p.mode} {p.source} winner={p.impl} ms: "
                  + " ".join(f"{k}={v:.4f}" for k, v in p.costs.items()))
        # the second plan's host work, split: the tensor's content key,
        # the per-mode stats pass, then the plan from the store
        t0 = time.perf_counter()
        key = content_key(t, block=DEFAULT_BLOCK, row_tile=DEFAULT_ROW_TILE)
        key_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = tensor_stats(t, block=DEFAULT_BLOCK,
                             row_tile=DEFAULT_ROW_TILE)
        stats_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = plan_decomposition(t, "auto", rank=RANK, calibrate=True,
                                   autotune=store, tensor_key=key,
                                   stats=stats)
        print(f"[plan] second plan: content key {key_s:.3f} s, stats "
              f"{stats_s:.3f} s, plan {time.perf_counter() - t0:.3f} s: "
              f"sources={[p.source for p in again.modes]} "
              f"impls={again.impls} hits={store.hits} misses={store.misses}")
    if (any(p.source != "measured-fresh" for p in plan.modes)
            or set(plan.modes[0].costs) != {
                "cuda", "gather_scatter", "linearized", "linearized_cuda",
                "segment"}):
        raise AssertionError("the first calibrated plan was not measured "
                             "over every candidate")
    if (any(p.source != "measured-cached" for p in again.modes)
            or again.impls != plan.impls or store.hits != t.order
            or store.misses != t.order):
        raise AssertionError("the second plan did not come from the store")
    zero_counts()
    dec_plan = fit(t, RANK, method="cp_als", plan=again, niters=NITERS,
                   state=state)
    print(f"[plan] fit with the plan {again.summary()}: launches "
          f"{read_counts()}")
    check_against_segment(dec_plan, "calibrated plan", factors_too=False)

    # --- 8. the Gram entry point: SYRK on the fitted model ------------------
    zero_counts()
    model_sq = float(kruskal_norm_sq(
        dec.lmbda, [gram(a, impl="cuda") for a in dec.factors]))
    gram_counts = read_counts()
    launches["syrk"] = gram_counts["syrk"]
    want_sq = float(kruskal_norm_sq(dec.lmbda,
                                    [gram(a) for a in dec.factors]))
    print(f"[gram] launches={gram_counts} model norm^2={model_sq:.6e}"
          f" plain={want_sq:.6e}")
    if gram_counts != dict(none, syrk=t.order):
        raise AssertionError(f"Gram path launches {gram_counts}, expected "
                             f"{t.order} SYRK and nothing else")
    if not abs(model_sq - want_sq) <= 1e-4 * abs(want_sq):
        raise AssertionError(f"model norm^2 {model_sq} vs plain {want_sq}")

    # --- 9. TTMc kernels at Kronecker width --------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    tf = tuple(torch.rand((d, r), generator=gen, device=dev)
               for d, r in zip(t.dims, TUCKER_RANKS))
    fb = tuple(a.bfloat16() for a in tf)

    def ttmc_bound(nnz_bytes: int, pnnz: int, mode: int):
        """Bound of one TTMc call: the workspace's stored entries (padding
        included, as the kernel reads them), the other factors and the
        output, against the operations the function needs for the tensor's
        non-zeros: the Kronecker row built up one factor at a time
        (val * F_1 row, then R_1 R_2 products, ... up to W) and one add per
        column, 16 + 256 + 256 = 528 flops an entry at (16, 16, 16)."""
        others = [r for m, r in enumerate(TUCKER_RANKS) if m != mode]
        width = math.prod(others)
        nbytes = (pnnz * nnz_bytes
                  + sum(t.dims[m] * TUCKER_RANKS[m] * 4
                        for m in range(t.order) if m != mode)
                  + t.dims[mode] * width * 4)
        per_entry = sum(math.prod(others[:j + 1])
                        for j in range(len(others))) + width
        ops_count = t.nnz * per_entry
        return nbytes, ops_count, *bound(nbytes, ops_count)

    k1t = totals()
    y_by_mode = {}
    for csf in csfs:
        got = ops.ttmc(csf, tf)
        err = max_err(torch, got, ref.ttmc_ref(csf, tf), rtol=1e-4,
                      atol=1e-4, what=f"K1-TTMc mode {csf.mode} float32")
        err_bf16 = max_err(torch, ops.ttmc(csf, fb),
                           ref.ttmc_ref(csf, fb).bfloat16(), rtol=5e-2,
                           atol=5e-2, what=f"K1-TTMc mode {csf.mode} bfloat16")
        ms = time_ms(torch, lambda: ops.ttmc(csf, tf))
        plain_ms = time_ms(torch, lambda: ref.ttmc_ref(csf, tf))
        nbytes, ops_count, b_ms, b_by = ttmc_bound(
            4 + 4 * (csf.order - 1) + 4, csf.padded_nnz, csf.mode)
        others = [TUCKER_RANKS[m] for m in csf.other_modes]
        gathered = gathered_bytes(csf.other_ids.unbind(1),
                                  [r * 4 for r in others])
        geo = mttkrp_cuda.ttmc_geometry(csf.padded_nnz, others)
        print(f"[K1-TTMc] mode {csf.mode} W={got.shape[1]} err f32={err:.3e}"
              f" bf16={err_bf16:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB, "
              f"{ops_count / 1e9:.2f} GFLOP); L2 gathers "
              f"{gathered / 1e9:.3f} GB at {gathered / ms / 1e6:.1f} GB/s; "
              f"{geo}")
        add_times(k1t, ms, plain_ms, nbytes, ops_count)
        k1t["max_abs_err"] = max(k1t["max_abs_err"], err)
        y_by_mode[csf.mode] = got
    k3t, k3toff = totals(), totals()
    for sm, lin in lins.items():
        got = ops.ttmc_lin(lin, tf, sm)
        err = max_err(torch, got, ref.ttmc_lin_ref(lin, tf, sm), rtol=1e-4,
                      atol=1e-4, what=f"K3-TTMc sort mode {sm} float32")
        err_k1 = max_err(torch, got, y_by_mode[sm], rtol=1e-4, atol=1e-4,
                         what=f"K3-TTMc vs K1-TTMc mode {sm}")
        err_bf16 = max_err(torch, ops.ttmc_lin(lin, fb, sm),
                           ref.ttmc_lin_ref(lin, fb, sm).bfloat16(),
                           rtol=5e-2, atol=5e-2,
                           what=f"K3-TTMc sort mode {sm} bfloat16")
        ms = time_ms(torch, lambda: ops.ttmc_lin(lin, tf, sm))
        plain_ms = time_ms(torch, lambda: ref.ttmc_lin_ref(lin, tf, sm))
        nbytes, ops_count, b_ms, b_by = ttmc_bound(12, lin.padded_nnz, sm)
        gathered = lin_gathers(lin, sm, TUCKER_RANKS)
        print(f"[K3-TTMc] sort mode {sm} err f32={err:.3e} vs "
              f"K1-TTMc={err_k1:.3e} bf16={err_bf16:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
              f"{nbytes / 1e6:.1f} MB, {ops_count / 1e9:.2f} GFLOP); L2 "
              f"gathers {gathered / 1e9:.3f} GB at "
              f"{gathered / ms / 1e6:.1f} GB/s")
        k3t["max_abs_err"] = max(k3t["max_abs_err"], err)
        if sm == 0:  # the sort mode the linearized Tucker fit runs
            add_times(k3t, ms, plain_ms, nbytes, ops_count)
        for tm in (m for m in range(t.order) if m != sm):
            got = ops.ttmc_lin(lin, tf, tm)
            what = f"off-sort TTMc sort mode {sm} mode {tm}"
            err = max_err(torch, got, ref.ttmc_lin_ref(lin, tf, tm),
                          rtol=1e-4, atol=1e-4, what=f"{what} float32")
            err_k1 = max_err(torch, got, y_by_mode[tm], rtol=1e-4,
                             atol=1e-4, what=f"{what} vs K1-TTMc")
            err_bf16 = max_err(torch, ops.ttmc_lin(lin, fb, tm),
                               ref.ttmc_lin_ref(lin, fb, tm).bfloat16(),
                               rtol=5e-2, atol=5e-2, what=f"{what} bfloat16")
            ms = time_ms(torch, lambda: ops.ttmc_lin(lin, tf, tm))
            plain_ms = time_ms(torch, lambda: ref.ttmc_lin_ref(lin, tf, tm))
            nbytes, ops_count, b_ms, b_by = ttmc_bound(12, lin.padded_nnz, tm)
            gathered = lin_gathers(lin, tm, TUCKER_RANKS)
            width = got.shape[1]
            red = atomic_runs(torch, lin.decode(tm), mttkrp_cuda.SEGMENT)
            print(f"[K3-off-TTMc] sort mode {sm} mode {tm} W={width} err "
                  f"f32={err:.3e} vs K1-TTMc={err_k1:.3e} bf16={err_bf16:.3e}"
                  f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f}"
                  f" ({b_by}, {nbytes / 1e6:.1f} MB, {ops_count / 1e9:.2f} "
                  f"GFLOP); L2 gathers {gathered / 1e9:.3f} GB at "
                  f"{gathered / ms / 1e6:.1f} GB/s; atomics {red} runs x "
                  f"{width} x 4 B = {red * width * 4 / 1e9:.3f} GB at "
                  f"{red * width * 4 / ms / 1e6:.1f} GB/s; output "
                  f"{t.dims[tm] * width * 4 / 1e6:.1f} MB")
            k3toff["max_abs_err"] = max(k3toff["max_abs_err"], err)
            if sm == 0:  # the modes the linearized Tucker fit runs
                add_times(k3toff, ms, plain_ms, nbytes, ops_count)
    del lins
    y2 = y_by_mode[2]
    svd_ms = time_ms(torch, lambda: torch.linalg.svd(y2, full_matrices=False),
                     warmup=1, reps=3)
    print(f"[svd] mode 2 Y {tuple(y2.shape)}: torch.linalg.svd ms="
          f"{svd_ms:.4f} (median of 3 after 1 warm-up)")
    del y_by_mode, y2, got

    # --- 10. the Tucker path ------------------------------------------------
    tinit = _init_orthonormal(t.dims, TUCKER_RANKS, args.seed + 4,
                              torch.float32, dev)
    tstate = make_state(tinit, {}, zero, zero, 0)
    sample = torch.randperm(t.nnz, generator=torch.Generator(device=dev)
                            .manual_seed(args.seed + 5), device=dev)[:100_000]
    sample_inds = t.inds[sample]

    def tucker_fit(impl: str, want_launches: dict[str, int]):
        """One 8-sweep timed Tucker fit from ``tstate``, launch counts set
        to 0 just before and checked just after."""
        timers: dict[str, float] = {}
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tdec = fit(t, TUCKER_RANKS, method="tucker_hooi", impl=impl,
                   niters=TUCKER_NITERS, timers=timers, state=tstate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(f"[tucker] impl={impl} fit={float(tdec.fit):.7f} "
              f"wall_s={wall:.4f} launches={counts} "
              + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                         for k in ("sort", "ttmc", "svd", "fit")))
        if counts != want_launches:
            raise AssertionError(f"tucker impl={impl} launches {counts}, "
                                 f"expected {want_launches}")
        if (tuple(tdec.core.shape) != TUCKER_RANKS
                or not torch.isfinite(tdec.core).all()
                or any(tuple(a.shape) != (d, r) or not torch.isfinite(a).all()
                       for a, d, r in zip(tdec.factors, t.dims,
                                          TUCKER_RANKS))):
            raise AssertionError(f"tucker impl={impl}: a core or factor of "
                                 "the wrong shape, or non-finite values")
        return tdec, dict(timers, wall=wall), counts

    tdec_seg, tseg_times, _ = tucker_fit("segment", dict(none))
    want_vals = tdec_seg.values_at(sample_inds)
    # the singular-value gap at the rank cut of each mode's final Y: what
    # decides how well the subspaces are defined
    sigma_gap = []
    for m, csf in enumerate(csfs):
        sv = torch.linalg.svdvals(ops.ttmc(csf, tdec_seg.factors))
        r = TUCKER_RANKS[m]
        sigma_gap.append((float(sv[r - 1]), float(sv[r])))
    print("[tucker] segment sigma_R, sigma_R+1 per mode: "
          + " ".join(f"({a:.6e}, {b:.6e})" for a, b in sigma_gap))

    def check_tucker(tdec, what: str) -> None:
        fit_diff = abs(float(tdec.fit) - float(tdec_seg.fit))
        got_vals = tdec.values_at(sample_inds)
        vals_rel = float(torch.linalg.norm(got_vals - want_vals)
                         / torch.linalg.norm(want_vals))
        gaps = [subspace_gap(torch, a, b)
                for a, b in zip(tdec.factors, tdec_seg.factors)]
        print(f"[tucker] {what} vs segment fit={float(tdec_seg.fit):.7f} "
              f"|diff|={fit_diff:.3e} values rel={vals_rel:.3e} max abs="
              f"{float((got_vals - want_vals).abs().max()):.3e} subspace="
              + " ".join(f"{g:.3e}" for g in gaps))
        if not math.isfinite(float(tdec.fit)) or fit_diff > 1e-5:
            raise AssertionError(f"{what}: fit {float(tdec.fit)} vs segment "
                                 f"{float(tdec_seg.fit)}")
        if vals_rel > 1e-3 or max(gaps) > 1e-3:
            raise AssertionError(f"{what}: values or a subspace differ from "
                                 "segment's by more than 1e-3")

    tdec, tcsf_times, tlaunches = tucker_fit(
        "cuda", dict(none, ttmc=t.order * TUCKER_NITERS))
    check_tucker(tdec, "impl=cuda")
    launches["ttmc"] = tlaunches["ttmc"]

    # --- 11. the linearized Tucker path ---------------------------------------
    tdec_lin, tlin_times, tlin_launches = tucker_fit(
        "linearized_cuda", dict(none, ttmc_lin=TUCKER_NITERS,
                                ttmc_off_sort=(t.order - 1) * TUCKER_NITERS))
    check_tucker(tdec_lin, "impl=linearized_cuda")
    for name in ("ttmc_lin", "ttmc_off_sort"):
        launches[name] = tlin_launches[name]
    print("[tucker] routine s (cuda | linearized_cuda | segment): "
          + " ".join(f"{k}={tcsf_times[k]:.4f}|{tlin_times[k]:.4f}|"
                     f"{tseg_times[k]:.4f}"
                     for k in ("sort", "ttmc", "svd", "fit", "wall")))

    # --- 12. the ingested path ----------------------------------------------
    import repro_torch.core.csf as csf_mod
    import repro_torch.core.linearized as lin_mod
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ingest import ingest, read_tnsb, write_tnsb

    builds = {"build_csf": 0, "build_linearized": 0}
    real_builds = {"build_csf": csf_mod.build_csf,
                   "build_linearized": lin_mod.build_linearized}

    def counted_build(name):
        def build(*a, **k):
            builds[name] += 1
            return real_builds[name](*a, **k)
        return build

    def step(what: str, seconds: float) -> None:
        print(f"[ingest] {what} s={seconds:.4f} on {card}")

    def sync_time(fn):
        """``(fn(), seconds)``, the card synchronised before and after."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="ingest-") as work:
        work = Path(work)
        path, cache = work / "yelp.tnsb", work / "cache"
        _, write_s = sync_time(lambda: write_tnsb(path, t))
        step(f"write_tnsb ({path.stat().st_size / 1e6:.1f} MB)", write_s)
        back, read_s = sync_time(lambda: read_tnsb(path, device=dev))
        step("read_tnsb", read_s)
        if (back.dims != t.dims or back.nnz != t.nnz
                or not torch.equal(back.inds, t.inds[: t.nnz])
                or not torch.equal(back.vals, t.vals[: t.nnz])):
            raise AssertionError("read_tnsb did not give back the tensor")
        del back

        csf_mod.build_csf = counted_build("build_csf")
        lin_mod.build_linearized = counted_build("build_linearized")
        try:
            cold, cold_s = sync_time(lambda: ingest(
                path, reorder="degree_sort", cache=cache, device=dev))
            cold_builds = dict(builds)
            step(f"cold ingest (degree_sort, linearized mode "
                 f"{cold.relabeling.linearized_mode}; builds {cold_builds})",
                 cold_s)
            del cold
            builds.update(dict.fromkeys(builds, 0))
            ing, warm_s = sync_time(lambda: ingest(
                path, reorder="degree_sort", cache=cache, device=dev))
            step(f"warm ingest (cache_hit={ing.cache_hit}, builds "
                 f"{builds})", warm_s)
        finally:
            csf_mod.build_csf = real_builds["build_csf"]
            lin_mod.build_linearized = real_builds["build_linearized"]
        if cold_builds != {"build_csf": t.order, "build_linearized": 1}:
            raise AssertionError(f"cold ingest builds {cold_builds}")
        if not ing.cache_hit or any(builds.values()):
            raise AssertionError(f"warm ingest: cache_hit={ing.cache_hit}, "
                                 f"builds {builds}")

        store = ing.cache.autotune
        iplan, plan1_s = sync_time(lambda: ing.plan("auto", rank=RANK,
                                                    calibrate=True))
        step(f"first calibrated plan {iplan.summary()} sources "
             f"{[p.source for p in iplan.modes]}", plan1_s)
        hits, misses = store.hits, store.misses
        iplan2, plan2_s = sync_time(lambda: ing.plan("auto", rank=RANK,
                                                     calibrate=True))
        step(f"warm plan {iplan2.summary()} hits={store.hits - hits} "
             f"misses={store.misses - misses}", plan2_s)
        if (any(p.source != "measured-cached" for p in iplan2.modes)
                or iplan2.impls != iplan.impls
                or store.hits - hits != t.order or store.misses != misses):
            raise AssertionError("the warm plan made a timing run")

        # HALS on the cached workspaces, from one nonnegative state
        hstate = make_state(ing.relabeling.apply_factors(init), {}, zero,
                            zero, 0)

        def hals_fit(impl: str, want_launches: dict[str, int]):
            timers: dict[str, float] = {}
            zero_counts()
            hdec, wall = sync_time(lambda: fit(
                ing, RANK, method="cp_nn_hals", impl=impl, niters=NITERS,
                timers=timers, state=hstate))
            counts = read_counts()
            print(f"[hals] impl={impl} fit={float(hdec.fit):.7f} "
                  f"wall_s={wall:.4f} launches={counts} "
                  + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                             for k in ROUTINES_FUSED) + f" on {card}")
            if counts != want_launches:
                raise AssertionError(f"hals impl={impl} launches {counts}, "
                                     f"expected {want_launches}")
            for m, a in enumerate(hdec.factors):
                if (tuple(a.shape) != (t.dims[m], RANK)
                        or not torch.isfinite(a).all() or a.min() < 0):
                    raise AssertionError(f"hals impl={impl} factor {m}: "
                                         "shape, non-finite or negative")
            return hdec

        hseg = hals_fit("segment", dict(none))
        check_against_segment(
            hals_fit("cuda", dict(none, mttkrp=t.order * NITERS)),
            "hals impl=cuda", want=hseg, tag="hals")
        check_against_segment(
            hals_fit("linearized_cuda",
                     dict(none, mttkrp_lin=NITERS,
                          mttkrp_off_sort=(t.order - 1) * NITERS)),
            "hals impl=linearized_cuda", want=hseg, tag="hals")

        # CP-ALS on the warm handle: no Sort; factors back in the tensor's
        # labels, held to phase 5's segment fit of the tensor itself
        wstate = CPALSState(ing.relabeling.apply_factors(init),
                            state.lmbda, zero, zero, state.iteration)
        timers = {}
        zero_counts()
        wdec, wall = sync_time(lambda: fit(
            ing, RANK, impl="cuda", niters=NITERS, timers=timers,
            fused_epilogue=True, state=wstate))
        print(f"[ingest] warm cuda fit={float(wdec.fit):.7f} wall_s="
              f"{wall:.4f} launches={read_counts()} "
              + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                         for k in ROUTINES_FUSED)
              + f" (phase 5's sort_s={csf_times['sort']:.4f}) on {card}")
        check_against_segment(wdec, "warm handle impl=cuda", tag="ingest")

        # checkpoint at every iteration of a 10-iteration run, then a fresh
        # manager restores the newest and a new fit resumes it to 20
        ckpt = CheckpointManager(work / "ckpt", keep=2)
        (_, ck_s) = sync_time(lambda: fit(
            ing, RANK, impl="cuda", niters=NITERS // 2, state=wstate,
            checkpoint_cb=lambda s: ckpt.save(int(s.iteration), s)))
        ckpt.wait()
        like = make_state(wstate.factors, {"lmbda": wstate.lmbda}, zero,
                          zero, 0)
        restored, extra = CheckpointManager(work / "ckpt").restore(like)
        zero_counts()
        rdec, resume_s = sync_time(lambda: fit(
            ing, RANK, impl="cuda", niters=NITERS, state=restored))
        step(f"checkpointed {NITERS // 2} iterations ({ck_s:.4f} s), "
             f"restored step {extra['step']} onto "
             f"{restored.factors[0].device}, resumed to {NITERS} "
             f"(launches {read_counts()['mttkrp']})", resume_s)
        if (extra["step"] != NITERS // 2
                or restored.factors[0].device.type != dev.type):
            raise AssertionError("the checkpoint did not restore onto the "
                                 "card at the last step")
        check_against_segment(rdec, "resumed", want=wdec, tag="ingest",
                              against="uninterrupted")

        # --- 13. streaming: the .tnsb one chunk at a time ------------------
        sstate = make_state(init, {"lmbda": state.lmbda}, zero, zero, 0)
        zero_counts()
        sdec, stream_s = sync_time(lambda: fit(
            path, RANK, method="cp_als_streaming", niters=STREAM_NITERS,
            state=sstate, device=dev))
        bdec = fit(ing, RANK, impl="segment", niters=STREAM_NITERS,
                   state=wstate)
        diff = abs(float(sdec.fit) - float(bdec.fit))
        print(f"[stream] {STREAM_NITERS} iterations, "
              f"{-(-t.nnz // (1 << 20))} chunks of 2^20: fit="
              f"{float(sdec.fit):.7f} batch segment fit="
              f"{float(bdec.fit):.7f} |diff|={diff:.3e} wall_s="
              f"{stream_s:.4f} launches={read_counts()} on {card}")
        if not math.isfinite(float(sdec.fit)) or diff > 1e-3:
            raise AssertionError(f"streamed fit {float(sdec.fit)} vs batch "
                                 f"{float(bdec.fit)}")
        del ing, hseg, wdec, rdec, sdec, bdec

    # --- 14. results --------------------------------------------------------
    kernels = [
        kernel_entry("mttkrp", "segmented.cuh",
                     "src/repro/kernels/mttkrp_pallas.py:49",
                     launches["mttkrp"], k1),
        kernel_entry("syrk", "syrk.cu", "src/repro/kernels/syrk_pallas.py:24",
                     launches["syrk"], k2),
        kernel_entry("mttkrp_lin", "segmented.cuh",
                     "src/repro/kernels/linearized_pallas.py:34",
                     launches["mttkrp_lin"], k3),
        kernel_entry("ttmc", "segmented.cuh",
                     "src/repro/kernels/mttkrp_pallas.py:49",
                     launches["ttmc"], k1t,
                     caller="src/repro/kernels/ops.py:77"),
        kernel_entry("ttmc_lin", "segmented.cuh",
                     "src/repro/kernels/linearized_pallas.py:34",
                     launches["ttmc_lin"], k3t,
                     caller="src/repro/kernels/ops.py:158"),
        kernel_entry("mttkrp_off_sort", "segmented.cuh",
                     "src/repro/core/mttkrp.py:239",
                     launches["mttkrp_off_sort"], k3off),
        kernel_entry("ttmc_off_sort", "segmented.cuh",
                     "src/repro/core/ttmc.py:157",
                     launches["ttmc_off_sort"], k3toff),
    ]
    print(f"[note] build {build_s:.3f} s; times: one call for each mode the "
          "main path runs, summed (mttkrp_lin and ttmc_lin: sort mode 0; "
          "mttkrp_off_sort and ttmc_off_sort: modes 1 and 2 of sort mode "
          "0); launches: mttkrp in fit(impl='cuda'), mttkrp_lin and "
          "mttkrp_off_sort in fit(impl='linearized_cuda'), syrk in "
          "gram(impl='cuda'), ttmc, ttmc_lin and ttmc_off_sort in the Tucker "
          "fits of the same impls")
    print(f"[total] chip_smoke.py ran {time.perf_counter() - start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
