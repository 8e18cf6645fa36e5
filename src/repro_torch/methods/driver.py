"""``fit()``: the one entry point over the decomposition-method registry.

    from repro_torch.methods import fit

    dec = fit(t, rank=35)                       # CP-ALS, segment impl
    dec = fit(t, rank=35, impl="cuda")          # the hand-written kernel

Counterpart of ``repro.methods.driver``.  Streaming methods and ingested
handles are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

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
    """Decompose the :class:`~repro_torch.core.coo.SparseTensor` ``x`` with
    a registered method, on ``x``'s device.

    ``checkpoint_cb`` always receives the shared :class:`DecompState`.
    Remaining keywords (``first_norm=``, ``timers=``, ``fused_epilogue=``, ...)
    forward to the method.
    """
    spec = get_method(method)
    if spec.supports_streaming:
        raise NotImplementedError(
            f"streaming method {method!r} is not ported to repro_torch yet")
    if not hasattr(x, "order"):
        raise TypeError(
            f"method {method!r} needs a materialized tensor (SparseTensor), "
            f"got {type(x).__name__}")
    if x.order > 3 and not spec.supports_order_gt3:
        raise ValueError(
            f"method {method!r} does not support order-{x.order} tensors")

    kwargs = dict(method_kwargs)
    if niters is not None:
        kwargs["niters"] = niters
    if impl is not None:
        kwargs["impl"] = impl
    if spec.name == "cp_als" and checkpoint_cb is not None:
        from .cp_als import cpals_state_to_decomp

        user_cb = checkpoint_cb
        checkpoint_cb = lambda s: user_cb(cpals_state_to_decomp(s))
    return spec.fn(x, rank, tol=tol, plan=plan, generator=generator,
                   state=state, checkpoint_cb=checkpoint_cb, monitor=monitor,
                   verbose=verbose, **kwargs)
