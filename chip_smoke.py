#!/usr/bin/env python3
"""Drive the PyTorch port's CP-ALS and Tucker paths on one CUDA card and
check them.

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and read the card's name and power limit,
   printed at the end, beside the numbers.
2. K1, MTTKRP: on each mode of the full-size yelp tensor (paper Table I
   shape, drawn on the card from the seed) at rank 35, the kernel against
   its plain version, in float32 (rtol/atol 1e-4: atomics change the order
   of summation) and in bfloat16 (5e-2).  Times, median of CUDA-event-timed
   calls after warm-up, beside the least time the card could take.
3. K2, SYRK: at the three factor shapes, against its plain version (rtol
   1e-4, atol 1e-3), and beside ``torch.matmul(a.T, a)`` as the library's
   yardstick (timed here only; the port never calls it).  Then the
   steady-state time of one mode's epilogue (the work after its MTTKRP).
4. K3, MTTKRP on the linearized workspace: ``build_linearized`` of the
   full yelp tensor with sort mode 0 (its row field straddles the two
   32-bit words) and sort mode 1 (its row field lies in the high word),
   the host build timed.  On each sort mode the kernel against its plain
   version (float32 at 1e-4, bfloat16 at 5e-2) and against K1 on that
   mode's CSF (1e-4: the same function on another layout), timed beside
   its bound (12 B a stored entry, the gathered factors, the output).
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
   (the sort mode, once an iteration; the other modes decode and
   ``index_add_``), K1 and SYRK none; held to ``segment`` as in phase 5.
   Its routine times print beside the CSF fit's.
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
   yelp tensor and K3-TTMc on sort modes 0 and 1, at Tucker ranks
   (16, 16, 16) (W = 256), each against its plain version (float32 at
   1e-4, bfloat16 at 5e-2), K3-TTMc also against K1-TTMc on the same
   mode's CSF, timed beside their bounds; then one thin SVD of mode 2's
   Y (75 000 x 256), the library call the fit makes after each TTMc.
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
   ``impl="linearized_cuda"``: K3-TTMc launches 8 times (sort mode 0;
   modes 1 and 2 decode and ``index_add_``), nothing else; held to
   ``segment`` as in phase 10.
12. One JSON line of kernel numbers, then, as the last line,
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
# NVIDIA H100 SXM data sheet (dense, no sparsity) at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for the work, and whether bytes or operations set
    it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
                "ttmc": mttkrp_cuda.ttmc, "ttmc_lin": linearized_cuda.ttmc}
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
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
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
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
          "ops_ms": 0.0, "max_abs_err": 0.0}
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
        print(f"[K1] mode {csf.mode} err f32={err:.3e} bf16={err_bf16:.3e}"
              f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}, {nbytes / 1e6:.1f} MB)")
        k1["ms"] += ms
        k1["plain_ms"] += plain_ms
        k1["bound_ms"] += b_ms
        k1["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        k1["ops_ms"] += ops_count / FP32_FLOP_PER_S * 1e3
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
    del got, want

    # --- 3. K2: SYRK at the factor shapes ----------------------------------
    k2 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "bytes_ms": 0.0, "ops_ms": 0.0, "max_abs_err": 0.0}
    for m, a in enumerate(factors):
        err = max_err(torch, ops.syrk(a), ref.syrk_ref(a), rtol=1e-4,
                      atol=1e-3, what=f"K2 factor {m}")
        ms = time_ms(torch, lambda: ops.syrk(a))
        plain_ms = time_ms(torch, lambda: ref.syrk_ref(a))
        library_ms = time_ms(torch, lambda: torch.matmul(a.T, a))
        rows = a.shape[0]
        nbytes = rows * RANK * 4 + RANK * RANK * 4
        ops_count = 2 * rows * RANK * RANK
        b_ms, b_by = bound(nbytes, ops_count)
        print(f"[K2] {rows}x{RANK} err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", b_ms),
                         ("bytes_ms", nbytes / HBM_BYTES_PER_S * 1e3),
                         ("ops_ms", ops_count / FP32_FLOP_PER_S * 1e3)):
            k2[key] += val
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
    k3 = {"max_abs_err": 0.0}
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
        nbytes = (lin.padded_nnz * 12
                  + sum(t.dims[m] * RANK * 4 for m in range(t.order)
                        if m != sm)
                  + t.dims[sm] * RANK * 4)
        ops_count = lin.padded_nnz * RANK * t.order
        b_ms, b_by = bound(nbytes, ops_count)
        print(f"[K3] sort mode {sm} err f32={err:.3e} vs K1={err_k1:.3e} "
              f"bf16={err_bf16:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB)")
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        if sm == 0:  # the sort mode the linearized fit runs
            k3.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
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

    def check_against_segment(dec, what: str, factors_too: bool = True):
        fit_got, fit_seg = float(dec.fit), float(dec_seg.fit)
        fit_diff = abs(fit_got - fit_seg)
        lmbda_rel, factor_rel = rel_diffs(torch, dec, dec_seg)
        print(f"[fit] {what} vs segment fit={fit_seg:.7f} "
              f"|diff|={fit_diff:.3e} lambda rel={lmbda_rel:.3e} factor rel="
              + " ".join(f"{r:.3e}" for r in factor_rel))
        if not math.isfinite(fit_got) or fit_diff > 1e-5:
            raise AssertionError(f"{what}: fit {fit_got} vs segment {fit_seg}")
        if factors_too and (lmbda_rel > 3e-2 or max(factor_rel) > 3e-2):
            raise AssertionError(f"{what}: lambda or a factor differs from "
                                 "segment's by more than a relative 3e-2")

    dec, csf_times, launches = timed_fit(
        "cuda", dict(none, mttkrp=t.order * NITERS))
    dec_seg = fit(t, RANK, method="cp_als", impl="segment", niters=NITERS,
                  state=state)
    check_against_segment(dec, "impl=cuda")

    # --- 6. the linearized path ---------------------------------------------
    dec_lin, lin_times, lin_launches = timed_fit(
        "linearized_cuda", dict(none, mttkrp_lin=NITERS))
    check_against_segment(dec_lin, "impl=linearized_cuda")
    launches["mttkrp_lin"] = lin_launches["mttkrp_lin"]
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

    k1t = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0, "max_abs_err": 0.0}
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
        print(f"[K1-TTMc] mode {csf.mode} W={got.shape[1]} err f32={err:.3e}"
              f" bf16={err_bf16:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB, "
              f"{ops_count / 1e9:.2f} GFLOP)")
        k1t["ms"] += ms
        k1t["plain_ms"] += plain_ms
        k1t["bound_ms"] += b_ms
        k1t["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        k1t["ops_ms"] += ops_count / FP32_FLOP_PER_S * 1e3
        k1t["max_abs_err"] = max(k1t["max_abs_err"], err)
        y_by_mode[csf.mode] = got
    k3t = {"max_abs_err": 0.0}
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
        print(f"[K3-TTMc] sort mode {sm} err f32={err:.3e} vs "
              f"K1-TTMc={err_k1:.3e} bf16={err_bf16:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
              f"{nbytes / 1e6:.1f} MB, {ops_count / 1e9:.2f} GFLOP)")
        k3t["max_abs_err"] = max(k3t["max_abs_err"], err)
        if sm == 0:  # the sort mode the linearized Tucker fit runs
            k3t.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
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
        "linearized_cuda", dict(none, ttmc_lin=TUCKER_NITERS))
    check_tucker(tdec_lin, "impl=linearized_cuda")
    launches["ttmc_lin"] = tlin_launches["ttmc_lin"]
    print("[tucker] routine s (cuda | linearized_cuda | segment): "
          + " ".join(f"{k}={tcsf_times[k]:.4f}|{tlin_times[k]:.4f}|"
                     f"{tseg_times[k]:.4f}"
                     for k in ("sort", "ttmc", "svd", "fit", "wall")))

    # --- 12. results --------------------------------------------------------
    kernels = [
        {"name": "mttkrp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mttkrp.cu",
         "replaces": "src/repro/kernels/mttkrp_pallas.py:49",
         "launches": launches["mttkrp"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"],
         "bound_by": ("bytes" if k1["bytes_ms"] >= k1["ops_ms"]
                      else "operations"),
         "library_ms": None},
        {"name": "syrk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/syrk.cu",
         "replaces": "src/repro/kernels/syrk_pallas.py:24",
         "launches": launches["syrk"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"],
         "bound_by": ("bytes" if k2["bytes_ms"] >= k2["ops_ms"]
                      else "operations"),
         "library_ms": k2["library_ms"]},
        {"name": "mttkrp_lin", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/linearized.cu",
         "replaces": "src/repro/kernels/linearized_pallas.py:34",
         "launches": launches["mttkrp_lin"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
        {"name": "ttmc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mttkrp.cu",
         "replaces": "src/repro/kernels/mttkrp_pallas.py:49",
         "caller": "src/repro/kernels/ops.py:77",
         "launches": launches["ttmc"], "max_abs_err": k1t["max_abs_err"],
         "ms": k1t["ms"], "plain_ms": k1t["plain_ms"],
         "bound_ms": k1t["bound_ms"],
         "bound_by": ("bytes" if k1t["bytes_ms"] >= k1t["ops_ms"]
                      else "operations"),
         "library_ms": None},
        {"name": "ttmc_lin", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/linearized.cu",
         "replaces": "src/repro/kernels/linearized_pallas.py:34",
         "caller": "src/repro/kernels/ops.py:158",
         "launches": launches["ttmc_lin"],
         "max_abs_err": k3t["max_abs_err"], "ms": k3t["ms"],
         "plain_ms": k3t["plain_ms"], "bound_ms": k3t["bound_ms"],
         "bound_by": k3t["bound_by"], "library_ms": None},
    ]
    print(f"[note] build {build_s:.3f} s; times: one call for each mode the "
          "main path runs, summed (mttkrp_lin and ttmc_lin: sort mode 0); "
          "launches: mttkrp in fit(impl='cuda'), mttkrp_lin in "
          "fit(impl='linearized_cuda'), syrk in gram(impl='cuda'), ttmc "
          "and ttmc_lin in the Tucker fits of the same impls")
    print(f"[total] chip_smoke.py ran {time.perf_counter() - start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
