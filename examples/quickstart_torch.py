"""Quickstart on the PyTorch port: decompose a small sparse tensor with
CP-ALS (the port's counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
  PYTHONPATH=src python examples/quickstart_torch.py --impl cuda

It runs on the CUDA card unless ``--device`` names another device, and
raises when no card is found.  ``--impl cuda`` runs the MTTKRP as the
hand-written Hopper kernel.  The tensor and the initial factors are drawn
from explicit ``torch.Generator``s seeded with 0 on the device:
the original example draws from ``jax.random``, a stream the port cannot
reproduce, so the values differ while the shape, non-zero count, skew,
rank and iterations are the original's.
"""
import argparse

import torch

from repro_torch.core import random_sparse, resolve_device
from repro_torch.methods import cp_als


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="segment",
                    help="MTTKRP impl or planner policy (e.g. segment, "
                         "auto, cuda, linearized_cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a synthetic 3rd-order sparse tensor (50k non-zeros, YELP-like skew)
    tensor = random_sparse((500, 400, 300), 50_000,
                           torch.Generator(device=dev).manual_seed(0),
                           skew=1.0, device=dev)
    density = tensor.nnz / (500 * 400 * 300)
    print(f"tensor: dims={tensor.dims} nnz={tensor.nnz} "
          f"density={density:.2e} on {dev}")

    # rank-16 CP decomposition, 10 ALS iterations (paper Alg. 1)
    decomp = cp_als(tensor, 16, niters=10, impl=args.impl,
                    generator=torch.Generator(device=dev).manual_seed(0),
                    verbose=True)
    print(f"final fit: {float(decomp.fit):.4f}")
    print(f"factor shapes: {[tuple(a.shape) for a in decomp.factors]}")
    print(f"lambda[:4] = {decomp.lmbda[:4].tolist()}")

    # reconstruct a few entries and compare
    approx = decomp.values_at(tensor.inds[:5])
    print("first 5 values  :", [round(float(v), 3) for v in tensor.vals[:5]])
    print("reconstructions :", [round(float(v), 3) for v in approx])
    return {"tensor": tensor, "decomp": decomp}


if __name__ == "__main__":
    main()
