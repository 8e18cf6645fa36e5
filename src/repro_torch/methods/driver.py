"""``fit()``: the one entry point over the decomposition-method registry.

    from repro_torch.methods import fit

    dec = fit(t, rank=35)                                  # CP-ALS, segment
    dec = fit(ingest("data.tnsb"), 35, impl="cuda")        # K1, cached CSFs
    dec = fit(t, 35, method="cp_nn_hals", niters=80)       # nonnegative CP
    dec = fit(t, (16, 16, 16), method="tucker_hooi")       # Tucker
    dec = fit("big.tnsb", 35, method="cp_als_streaming")   # streaming

Counterpart of ``repro.methods.driver``: a capability-checked dispatch.
Every method shares the planner and ingest stack (``plan=`` skips
planning, ``Ingested`` handles reuse ingest-time stats and cached
workspaces, factors come back in original labels) and the
:class:`DecompState` resume protocol (``state=`` / ``checkpoint_cb=``).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.coo import SparseTensor
from repro_torch.ingest.api import Ingested

from .registry import DecompState, get_method


def fit(
    x,
    rank,
    *,
    method: str = "cp_als",
    niters: Optional[int] = None,
    tol: float = 0.0,
    impl: Optional[str] = None,
    plan=None,
    generator=None,
    state: Optional[DecompState] = None,
    checkpoint_cb: Optional[Callable[[DecompState], None]] = None,
    monitor=None,
    verbose: bool = False,
    **method_kwargs,
):
    """Decompose ``x`` with a registered method, on ``x``'s device.

    ``x``: a :class:`~repro_torch.core.coo.SparseTensor`, a
    :class:`~repro_torch.ingest.Ingested` handle, or, for streaming-capable
    methods, a ``.tns``/``.tnsb`` path or a chunk list (on ``device=``, the
    card by default).  ``rank``: an int for the CP family, an int or
    per-mode tuple for Tucker.  ``checkpoint_cb`` always receives the
    shared :class:`DecompState`.  Remaining keywords (``first_norm=``,
    ``timers=``, ``decay=``, ``chunk_nnz=``, ``device=``, ...) forward to
    the method.
    """
    spec = get_method(method)

    is_tensorish = hasattr(x, "order")  # SparseTensor / Ingested both have it
    if not is_tensorish and not spec.supports_streaming:
        raise TypeError(
            f"method {method!r} needs a materialized tensor "
            f"(SparseTensor or Ingested), got {type(x).__name__}; only "
            "streaming-capable methods accept paths/chunk sources "
            f"(see available_methods(streaming=True))")
    if is_tensorish and x.order > 3 and not spec.supports_order_gt3:
        raise ValueError(
            f"method {method!r} does not support order-{x.order} tensors")

    ing = None
    if spec.supports_streaming and is_tensorish:
        if isinstance(x, Ingested):
            # streaming folds raw chunks and never builds the handle's
            # sorted workspaces: unwrap the (relabeled) tensor here and
            # restore the original labels on the way out
            ing = x
            x = ing.tensor
        elif not isinstance(x, SparseTensor):
            raise TypeError(
                f"method {method!r} takes a SparseTensor, an Ingested "
                f"handle, a .tns/.tnsb path, or a chunk list; got "
                f"{type(x).__name__}")

    kwargs = dict(method_kwargs)
    if niters is not None:
        kwargs["niters"] = niters
    if impl is not None:
        kwargs["impl"] = impl
    if spec.name == "cp_als" and checkpoint_cb is not None:
        from .cp_als import cpals_state_to_decomp

        user_cb = checkpoint_cb
        checkpoint_cb = lambda s: user_cb(cpals_state_to_decomp(s))
    result = spec.fn(x, rank, tol=tol, plan=plan, generator=generator,
                     state=state, checkpoint_cb=checkpoint_cb,
                     monitor=monitor, verbose=verbose, **kwargs)
    return result if ing is None else ing.restore(result)
