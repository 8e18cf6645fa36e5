#!/usr/bin/env python3
"""Drive the PyTorch port's CP-ALS main path on one CUDA card and check it.

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
4. The main path: ``repro_torch.methods.fit(t, 35, method="cp_als",
   impl="cuda", niters=20, timers=...)`` on yelp, with every launch count
   set to 0 just before and read just after: MTTKRP must launch 3 modes x
   20 iterations = 60 times; SYRK none, since the driver keeps ``A.T @ A``
   as the reference's does.  Against the plain ``impl="segment"`` run from
   the same initial factors, its fit must agree within 1e-5, and lambda and
   each factor within a relative 3e-2: the kernel's float atomics reorder
   its sums, and the ALS solves against the Grams' hadamard product
   amplify that to a relative 1e-3 to 7e-3 already.
5. The Gram entry point, SYRK's path: ``gram(a, impl="cuda")`` on the
   fitted factors, with the counts set to 0 just before; 3 launches, and
   the model's norm from those Grams within 1e-4 of the plain Grams'.
6. One JSON line of kernel numbers, then, as the last line,
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
import time
from pathlib import Path

RANK = 35
NITERS = 20
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import build_all_modes, init_factors, paper_dataset
    from repro_torch.core.cpals import (ROUTINES_FUSED, CPALSState,
                                        _mode_epilogue)
    from repro_torch.core.gram import gram, kruskal_norm_sq
    from repro_torch.kernels import _build, mttkrp_cuda, ops, ref, syrk_cuda
    from repro_torch.methods import fit

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

    # --- 4. the main path ---------------------------------------------------
    init = init_factors(t.dims, RANK, args.seed + 2, device=dev)
    zero = torch.tensor(0.0, device=dev)
    state = CPALSState(init, torch.ones(RANK, device=dev), zero, zero,
                       torch.tensor(0, dtype=torch.int32))
    timers: dict[str, float] = {}
    mttkrp_cuda.mttkrp.launches = 0
    syrk_cuda.syrk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = fit(t, RANK, method="cp_als", impl="cuda", niters=NITERS,
              timers=timers, fused_epilogue=True, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mttkrp": mttkrp_cuda.mttkrp.launches,
                "syrk": syrk_cuda.syrk.launches}
    want_launches = {"mttkrp": t.order * NITERS, "syrk": 0}
    print(f"[fit] impl=cuda fit={float(dec.fit):.7f} wall_s={wall:.4f} "
          f"launches={launches} "
          + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                     for k in ROUTINES_FUSED))
    if launches != want_launches:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{want_launches}")
    for m, a in enumerate(dec.factors):
        if tuple(a.shape) != (t.dims[m], RANK) or not torch.isfinite(a).all():
            raise AssertionError(f"factor {m}: shape {tuple(a.shape)} or "
                                 "non-finite values")
    dec_seg = fit(t, RANK, method="cp_als", impl="segment", niters=NITERS,
                  state=state)
    fit_cuda, fit_seg = float(dec.fit), float(dec_seg.fit)
    fit_diff = abs(fit_cuda - fit_seg)
    lmbda_rel, factor_rel = rel_diffs(torch, dec, dec_seg)
    print(f"[fit] impl=segment fit={fit_seg:.7f} |diff|={fit_diff:.3e} "
          f"lambda rel={lmbda_rel:.3e} factor rel="
          + " ".join(f"{r:.3e}" for r in factor_rel))
    if not math.isfinite(fit_cuda) or fit_diff > 1e-5:
        raise AssertionError(f"fit {fit_cuda} vs segment {fit_seg}")
    if lmbda_rel > 3e-2 or max(factor_rel) > 3e-2:
        raise AssertionError("lambda or a factor differs from segment's by "
                             "more than a relative 3e-2")

    # --- 5. the Gram entry point: SYRK on the fitted model ------------------
    mttkrp_cuda.mttkrp.launches = 0
    syrk_cuda.syrk.launches = 0
    model_sq = float(kruskal_norm_sq(
        dec.lmbda, [gram(a, impl="cuda") for a in dec.factors]))
    launches["syrk"] = syrk_cuda.syrk.launches
    want_sq = float(kruskal_norm_sq(dec.lmbda,
                                    [gram(a) for a in dec.factors]))
    print(f"[gram] launches={launches['syrk']} model norm^2={model_sq:.6e}"
          f" plain={want_sq:.6e}")
    if launches["syrk"] != t.order or mttkrp_cuda.mttkrp.launches != 0:
        raise AssertionError(f"Gram path launched SYRK {launches['syrk']} "
                             f"times, expected {t.order}")
    if not abs(model_sq - want_sq) <= 1e-4 * abs(want_sq):
        raise AssertionError(f"model norm^2 {model_sq} vs plain {want_sq}")

    # --- 6. results ---------------------------------------------------------
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
    ]
    print(f"[note] build {build_s:.3f} s; times: one call a mode, summed; "
          "launches: mttkrp in fit(), syrk in gram(impl='cuda')")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
