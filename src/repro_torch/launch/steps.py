"""Step builders: prefill_step / serve_step for an LM config, and the
CP-ALS iteration step for decomposition workloads.

Counterpart of ``repro.launch.steps``.  The parameters live in the
:class:`~repro_torch.models.Model` (the PyTorch idiom), so the LM steps
take no ``params`` argument; they run without autograd and update the
cache in place.  ``make_train_step`` waits for training (ROADMAP §1 item
10b-2).
"""
from __future__ import annotations

import torch

from repro_torch.models import Model


def make_cpals_step(plan):
    """One CP-ALS iteration executing a :class:`repro_torch.plan.DecompPlan`.

    Returns ``(ws, factors, grams, norm_x_sq, norm_kind) -> (factors, grams,
    lmbda, fit)`` where ``ws`` is ``repro_torch.core.build_workspace(t,
    plan)``, so the per-mode impl selection is decided once at plan time,
    not per step."""
    from repro_torch.core.cpals import _iteration

    impls = plan.impls

    def cpals_step(ws, factors, grams, norm_x_sq, *, norm_kind="2"):
        return _iteration(ws, tuple(factors), tuple(grams), norm_x_sq,
                          impls=impls, norm_kind=norm_kind)

    return cpals_step


def make_prefill_step(model: Model):
    """(batch, cache) -> (logits (B,1,V), cache, metrics): the reference's
    prefill step, with the forward's metrics (the MoE blocks') beside it."""
    def prefill_step(batch, cache):
        with torch.no_grad():
            return model(batch, mode="prefill", cache=cache)
    return prefill_step


def make_serve_step(model: Model):
    """One decode step: (tokens (B,1), cache, pos) -> (logits, cache)."""
    def serve_step(tokens, cache, pos, positions=None):
        return model.decode_step(tokens, cache, pos, positions=positions)
    return serve_step
