"""CP-compress an embedding table on the PyTorch port (the port's
counterpart of ``examples/compress_embeddings.py``).

A (V, D) embedding reshaped to a 3rd-order tensor (V1, V2, D) admits a CP
decomposition whose factors store V1*R + V2*R + D*R floats instead of V*D:
the paper's sparse CP-ALS runs on the fully observed reshaped table, and
the compression ratio and the reconstruction error on a sample of entries
are reported.

  PYTHONPATH=src python examples/compress_embeddings_torch.py --device cpu
  PYTHONPATH=src python examples/compress_embeddings_torch.py

It runs on the CUDA card unless ``--device`` names another device, and
raises when no card is found.  The table and the initial factors are drawn
from an explicit ``torch.Generator`` seeded with 0 on the device (the
original draws from ``jax.random``, a stream the port cannot reproduce).
"""
import argparse

import torch

from repro_torch.core import SparseTensor, resolve_device
from repro_torch.methods import cp_als

V1, V2, D, R = 64, 64, 128, 24          # a 4096 x 128 table
SIGNAL_RANK, NOISE = 8, 0.05


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)

    # Tensorized-embedding assumption (Khrulkov et al.): vocabulary rows
    # carry Kronecker structure over the (V1, V2) index split, i.e. the
    # reshaped (V1, V2, D) tensor is low CP-rank.  Build such a table
    # (+ noise):
    a, b = (torch.randn((n, SIGNAL_RANK), generator=g, device=dev)
            for n in (V1, V2))
    v = torch.randn((SIGNAL_RANK, D), generator=g, device=dev)
    table = (torch.einsum("ir,jr,rd->ijd", a, b, v).reshape(V1 * V2, D)
             + NOISE * torch.randn((V1 * V2, D), generator=g, device=dev))

    t3 = table.reshape(V1, V2, D)
    # the fully observed table in COO form: the decomposition engine is the
    # paper's sparse CP-ALS; density is 1.0 here, the machinery is the same
    inds = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=dev) for n in (V1, V2, D)), indexing="ij"),
        dim=-1).reshape(-1, 3)
    tensor = SparseTensor(inds, t3.reshape(-1), (V1, V2, D), t3.numel(),
                          device=dev)
    print(f"embedding tensor: {V1}x{V2}x{D} = {t3.numel():,} entries on "
          f"{dev}")

    dec = cp_als(tensor, R, niters=30, impl="segment", generator=g)
    orig_floats = V1 * V2 * D
    comp_floats = (V1 + V2 + D) * R + R
    sample = tensor.inds[:4096]
    recon = dec.values_at(sample)
    truth = t3[sample[:, 0].long(), sample[:, 1].long(), sample[:, 2].long()]
    err = float(torch.linalg.norm(recon - truth) / torch.linalg.norm(truth))
    print(f"fit={float(dec.fit):.3f}  sampled rel-err={err:.3f}")
    print(f"compression: {orig_floats:,} -> {comp_floats:,} floats "
          f"({orig_floats / comp_floats:.1f}x)")
    assert float(dec.fit) > 0.5, \
        "rank-24 CP should capture the rank-8 signal"
    return {"decomp": dec, "rel_err": err}


if __name__ == "__main__":
    main()
