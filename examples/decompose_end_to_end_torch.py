"""End-to-end reproduction of the paper's experiment on the PyTorch port,
through the one front door (the port's counterpart of
``examples/decompose_end_to_end.py``): a declarative
:class:`repro_torch.api.RunConfig` per run, driven by
:class:`repro_torch.api.Session` (ingest -> per-mode plan -> method
registry).

Stage 1 reproduces Table III: 20 CP-ALS iterations at rank 35 on YELP- and
NELL-2-shaped tensors with the per-routine runtime breakdown, comparing the
implementation-strategy ablation (gather_scatter = atomic regime, segment =
no-lock regime, auto = the per-mode planner; ``--impl`` adds the
hand-written kernels, ``cuda`` and ``linearized_cuda``).

Stage 2 goes past the paper: the same tensors through every method in the
registry (nonnegative HALS, Tucker/HOOI over the TTMc kernel, streaming
CP-ALS over chunk batches): fit against wall time.

  PYTHONPATH=src python examples/decompose_end_to_end_torch.py --device cpu
  PYTHONPATH=src python examples/decompose_end_to_end_torch.py \\
      --impl gather_scatter segment auto cuda linearized_cuda

It runs on the CUDA card unless ``--device`` names another device, and
raises when no card is found.  Each tensor is drawn from an explicit
``torch.Generator`` seeded with 7 on the device (the original
draws from ``jax.random``, a stream the port cannot reproduce).
"""
import argparse
import time

import torch

from repro_torch.api import (ExecConfig, MethodConfig, PlanConfig, RunConfig,
                             Session)
from repro_torch.core import paper_dataset, resolve_device
from repro_torch.ingest import ingest
from repro_torch.methods import available_methods, get_method


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.004,
                    help="fraction of the published nnz (CPU-sized default)")
    ap.add_argument("--rank", type=int, default=35)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--impl", nargs="+",
                    default=["gather_scatter", "segment", "auto"],
                    help="the planner policies of the Table III ablation")
    ap.add_argument("--skip-methods", action="store_true",
                    help="only the Table III CP-ALS ablation")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    fits = {}
    for name in ("yelp", "nell-2"):
        t = paper_dataset(name, torch.Generator(device=dev).manual_seed(7),
                          scale=args.scale, device=dev)
        # ingest ONCE; every Session below adopts the same handle (sort +
        # stats + CSF builds are shared across all runs on this tensor)
        ing = ingest(t)
        print(f"\n=== {name}: dims={t.dims} nnz={t.nnz:,} (scale "
              f"{args.scale}) on {dev} ===")

        # --- Table III ablation: one method (cp_als), the impl policies ---
        for impl in args.impl:
            # warm-up run, then the timed one; ``timers`` is a method
            # option, the per-routine out-param the breakdown reads
            Session.from_config(RunConfig(
                plan=PlanConfig(policy=impl),
                method=MethodConfig(rank=args.rank, niters=2, seed=7,
                                    options={"timers": {}})),
                tensor=ing).fit()
            timers: dict = {}
            cfg = RunConfig(plan=PlanConfig(policy=impl),
                            method=MethodConfig(rank=args.rank,
                                                niters=args.iters,
                                                seed=7,
                                                options={"timers": timers}))
            dec = Session.from_config(cfg, tensor=ing).fit()
            fits[(name, "cp_als", impl)] = float(dec.fit)
            total = sum(timers.values())
            print(f"[cp_als/{impl:>15s}] fit={float(dec.fit):.4f} "
                  f"total={total:.2f}s | "
                  + "  ".join(f"{k}={timers.get(k, 0.0):.3f}s"
                              for k in ("sort", "mttkrp", "ata", "inverse",
                                        "norm", "fit")))

        # --- the registry: every method on the same tensor ---------------
        if args.skip_methods:
            continue
        for method in available_methods(order=t.order):
            spec = get_method(method)
            # HOOI converges in a few sweeps (and each carries a thin SVD)
            niters = args.iters if spec.family == "cp" else min(args.iters,
                                                                5)
            cfg = RunConfig(
                method=MethodConfig(name=method, rank=args.rank,
                                    niters=niters, seed=7),
                exec=ExecConfig(n_chunks=4 if spec.supports_streaming
                                else None))
            sess = Session.from_config(cfg, tensor=ing)
            t0 = time.perf_counter()
            dec = sess.fit()
            sess.synchronize()
            wall = time.perf_counter() - t0
            fits[(name, method, "auto")] = float(dec.fit)
            print(f"[{method:>22s}] family={spec.family} "
                  f"kernel={spec.kernel} fit={float(dec.fit):.4f} "
                  f"wall={wall:.2f}s")
    return fits


if __name__ == "__main__":
    main()
