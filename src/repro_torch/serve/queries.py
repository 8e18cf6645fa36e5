"""The serving query vocabulary: batched ``values_at`` + ``top_k_for_user``
(counterpart of ``repro.serve.queries``).

A fitted decomposition answers two kinds of production queries:

* **values_at**: reconstruct the tensor at a coordinate batch (what
  ``ServeHandle.query`` serves).  :func:`pad_rows` and :func:`bucket_for`
  pad a batch up to one of a fixed set of sizes, so the server's batches
  land on a few shapes.

* **top_k_for_user**: score ONE user row against ALL items and return the
  k best.  For a rank-R CP model everything outside the user and item
  modes collapses into one per-rank weight vector (lambda times the column
  sums of every remaining factor), so a batch of users is one GEMM against
  the item factor:

      score[u, i] = sum_r (A_user[u, r] * w_r) * A_item[i, r]
      w_r         = lambda_r * prod_{m not in {user, item}} sum_j A_m[j, r]

  For Tucker the same marginalization contracts the core with the other
  factors' column sums down to an (R_user, R_item) matrix ``B`` and scores
  are ``(U_user[users] @ B) @ U_item.T``.  Either way: one small GEMM, then
  ``torch.topk``.

Factors on a served decomposition live in the tensor's ORIGINAL label
space (``Ingested.restore`` maps them back after a reordered fit), so the
item ids returned here are original labels.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

QUERY_KINDS = ("values_at", "top_k")


# ---------------------------------------------------------------------------
# bucketed padding
# ---------------------------------------------------------------------------


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n (callers chunk anything beyond the largest
    bucket, so asking for more is a bug here, not a silent spill)."""
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{max(buckets)}; chunk before bucketing")


def pad_rows(x, n_rows: int):
    """Zero-pad the leading axis up to ``n_rows`` (a no-op at size), on the
    host in numpy.  Zeros are valid padding for both query kinds:
    coordinate (0, ..., 0) reconstructs fine and user 0 scores fine; the
    padded results are sliced away."""
    x = np.asarray(x)
    pad = n_rows - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate(
        [x, np.zeros((pad,) + x.shape[1:], dtype=x.dtype)], axis=0)


# ---------------------------------------------------------------------------
# top-k scoring
# ---------------------------------------------------------------------------


def make_score_fn(decomp, *, user_mode: int = 0,
                  item_mode: int = 1) -> Callable[[Tensor], Tensor]:
    """``score(users) -> (n_users, n_items)`` marginal scores for a CP
    (``lmbda``) or Tucker (``core``) decomposition.  Everything that does
    not depend on the user batch (the weight vector, the contracted core)
    is computed once here."""
    if not hasattr(decomp, "factors") or not (
            hasattr(decomp, "lmbda") or hasattr(decomp, "core")):
        raise TypeError(
            f"top_k needs a CP (lmbda) or Tucker (core) decomposition, got "
            f"{type(decomp).__name__}")
    order = len(decomp.factors)
    if user_mode == item_mode or not (0 <= user_mode < order
                                      and 0 <= item_mode < order):
        raise ValueError(
            f"user_mode={user_mode} / item_mode={item_mode} must be two "
            f"distinct modes of an order-{order} decomposition")
    user_f = decomp.factors[user_mode]
    item_f = decomp.factors[item_mode]
    others = [m for m in range(order) if m not in (user_mode, item_mode)]

    if hasattr(decomp, "lmbda"):  # CP family
        weights = decomp.lmbda
        for m in others:
            weights = weights * torch.sum(decomp.factors[m], dim=0)

        def score(users: Tensor) -> Tensor:
            return (user_f[users] * weights[None, :]) @ item_f.T

        return score

    letters = "abcdefgh"[:order]  # Tucker
    operands = [decomp.core]
    terms = [letters]
    for m in others:
        operands.append(torch.sum(decomp.factors[m], dim=0))
        terms.append(letters[m])
    eq = ",".join(terms) + "->" + letters[user_mode] + letters[item_mode]
    b_mat = torch.einsum(eq, *operands)  # (R_user, R_item)

    def score(users: Tensor) -> Tensor:
        return (user_f[users] @ b_mat) @ item_f.T

    return score


def make_top_k_fn(decomp, *, user_mode: int = 0, item_mode: int = 1):
    """``top_k(users, k) -> (scores (n, k), items (n, k))`` over a user
    batch, the best first (``torch.topk``)."""
    score = make_score_fn(decomp, user_mode=user_mode, item_mode=item_mode)
    n_items = int(decomp.factors[item_mode].shape[0])

    def top_k(users: Tensor, k: int):
        return torch.topk(score(users), min(int(k), n_items), dim=1)

    return top_k


def resident_bytes(decomp) -> int:
    """The decomposition's resident-memory footprint: factor matrices plus
    the CP weight vector / Tucker core."""
    total = sum(f.numel() * f.element_size() for f in decomp.factors)
    for attr in ("lmbda", "core"):
        arr = getattr(decomp, attr, None)
        if arr is not None:
            total += arr.numel() * arr.element_size()
    return int(total)
