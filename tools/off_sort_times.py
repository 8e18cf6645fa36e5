"""Times of the linearized workspace's kernels and fits on one CUDA card,
for one tree of the repository, so that two trees (a parent and a change)
can run in turns in one call and be compared:

1. full yelp (``paper_dataset("yelp", seed, scale=1.0)``) and its
   linearized workspace at sort modes 0 and 1;
2. on every mode of each, the MTTKRP at R = 35 and the TTMc at ranks
   (16, 16, 16) through ``kernels.ops`` (the sort mode's kernel, or the
   off-sort one): the first call timed on the host clock between device
   synchronisations (it builds whatever the call caches), then the median
   of 15 CUDA-event-timed calls after 3 warm-up calls;
3. ``fit(impl="linearized_cuda")``: ``cp_als`` at R = 35, 20 iterations,
   and ``tucker_hooi`` at (16, 16, 16), 8 sweeps, from fixed initial
   factors, their routine seconds (``timers=``) and wall time.

  python3 tools/off_sort_times.py [--root TREE] [--seed N]

``--root`` is the tree whose ``src/`` is imported (this checkout when left
out).  Prints one line a measurement, then the card's name and power limit
and one JSON object of every number.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RANK = 35
TUCKER_RANKS = (16, 16, 16)


def event_ms(torch, fn, *, warmup: int = 3, reps: int = 15) -> float:
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


def host_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("off_sort_times: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.core import build_linearized, init_factors, paper_dataset
    from repro_torch.core.cpals import CPALSState
    from repro_torch.kernels import _build, ops
    from repro_torch.methods import fit, make_state
    from repro_torch.methods.tucker_hooi import _init_orthonormal

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t = paper_dataset("yelp", args.seed, scale=1.0, device=dev)
    factors = init_factors(t.dims, RANK, args.seed + 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    tf = tuple(torch.rand((d, r), generator=gen, device=dev)
               for d, r in zip(t.dims, TUCKER_RANKS))
    out = {"root": str(args.root), "card": card, "kernels": {}, "fits": {}}

    for sm in (0, 1):
        lin = build_linearized(t, sort_mode=sm)
        # the library's load, outside every timed call
        ops.mttkrp_lin(lin, factors, sm)
        ops.ttmc_lin(lin, tf, sm)
        for mode in range(t.order):
            for name, call, f in (("mttkrp", ops.mttkrp_lin, factors),
                                  ("ttmc", ops.ttmc_lin, tf)):
                first = host_ms(torch, lambda: call(lin, f, mode))
                ms = event_ms(torch, lambda: call(lin, f, mode))
                key = f"{name} sort mode {sm} mode {mode}"
                out["kernels"][key] = {"first_ms": first, "ms": ms}
                print(f"[kernel] {key}: first call {first:.4f} ms, then "
                      f"{ms:.4f} ms (median of 15)")
        del lin

    init = init_factors(t.dims, RANK, args.seed + 2, device=dev)
    zero = torch.tensor(0.0, device=dev)
    state = CPALSState(init, torch.ones(RANK, device=dev), zero, zero,
                       torch.tensor(0, dtype=torch.int32))
    tstate = make_state(_init_orthonormal(t.dims, TUCKER_RANKS,
                                          args.seed + 4, torch.float32, dev),
                        {}, zero, zero, 0)
    for method, rank, extra in (
            ("cp_als", RANK, dict(niters=20, state=state,
                                  fused_epilogue=True)),
            ("tucker_hooi", TUCKER_RANKS, dict(niters=8, state=tstate))):
        timers: dict[str, float] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = fit(t, rank, method=method, impl="linearized_cuda",
                  timers=timers, **extra)
        torch.cuda.synchronize()
        timers["wall"] = time.perf_counter() - t0
        timers["fit_value"] = float(dec.fit)
        out["fits"][method] = timers
        print(f"[fit] {method} linearized_cuda: "
              + " ".join(f"{k}={v:.7f}" for k, v in timers.items()))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
