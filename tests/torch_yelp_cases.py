"""Tensors at yelp's dims shared by the row-segmented kernels' CPU tests
(``test_torch_segmented.py``) and card tests (``test_torch_cuda.py``).

A module of its own, not a conftest, and JAX-free, so that the card tests
run with ``--noconftest`` on a machine without JAX.
"""
import numpy as np
import torch

from repro_torch.core import SparseTensor, dedupe

YELP = (41_000, 11_000, 75_000)  # the paper's Table I shape


def hot_yelp_tensor(device="cpu", *, empty_tiles, seed=31):
    """yelp's dims with a hot row in each of modes 0 and 1 (3000 and 2000
    entries: more than two warp ranges of 512 and blocks of 512), and a thin
    spread; with ``empty_tiles`` no entry has a mode-0 or mode-1 row in
    128..255, so row tile 1 (at 128 rows) of either is one block of
    padding."""
    rng = np.random.default_rng(seed)
    d0, d1, d2 = YELP
    n_thin = 5000
    rows0 = np.concatenate([np.full(3000, 1), rng.integers(0, d0, 2000),
                            rng.integers(0, d0, n_thin)])
    rows1 = np.concatenate([rng.integers(0, d1, 3000), np.full(2000, 2),
                            rng.integers(0, d1, n_thin)])
    if empty_tiles:
        rows0 = np.where((rows0 >= 128) & (rows0 < 256), rows0 % 128, rows0)
        rows1 = np.where((rows1 >= 128) & (rows1 < 256), rows1 % 128, rows1)
    inds = np.stack([rows0, rows1, rng.integers(0, d2, rows0.shape[0])], 1)
    vals = rng.uniform(0.1, 1.0, rows0.shape[0]).astype(np.float32)
    return dedupe(SparseTensor(torch.from_numpy(inds), torch.from_numpy(vals),
                               YELP, inds.shape[0], device=device))
