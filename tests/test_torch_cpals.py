"""The port's CP-ALS slice (driver, method registry, iteration machinery)
against the JAX package's, from the same tensor and initial factors.

Summation order differs between XLA and PyTorch, so parity is held with
stated tolerances: the fit within 1e-4 absolute and the factors within 1e-2
(the tolerance of ``test_cpals_pallas_impl_matches_segment``).  Bit-exact
resume is checked only against the port's own uninterrupted run.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cpals import CPDecomp as JaxCPDecomp
from repro.methods import fit as jax_fit
from repro_torch import convert
from repro_torch.core.coo import PAPER_DATASETS
from repro_torch.core.cpals import (EPILOGUE_ROUTINES, ROUTINES,
                                    ROUTINES_FUSED, CPALSState, CPDecomp,
                                    build_workspace)
from repro_torch.methods import (DecompState, available_methods, fit,
                                 get_method, make_state)
from repro_torch.plan import plan_decomposition

from test_torch_helpers import both_states, both_tensors, np_coo, np_factors

RANK = 6


def paper_like(name, scale, seed=0):
    """A small tensor with the shape recipe of ``paper_dataset``, in numpy."""
    dims, nnz, skew = PAPER_DATASETS[name]
    dims = tuple(max(8, int(d * scale ** (1 / 3))) for d in dims)
    inds, vals = np_coo(dims, max(64, int(nnz * scale)), seed, skew=skew)
    return dims, inds, vals


CASES = {"yelp": ("yelp", 2e-4), "nell-2": ("nell-2", 2e-5)}


def _run_both(case, impl, niters=20):
    dims, inds, vals = paper_like(*CASES[case])
    jt, pt = both_tensors(inds, vals, dims)
    jstate, pstate = both_states(np_factors(dims, RANK, 1))
    jd = jax_fit(jt, RANK, method="cp_als", impl=impl, niters=niters,
                 state=jstate)
    pd = fit(pt, RANK, method="cp_als", impl=impl, niters=niters,
             state=pstate)
    return jd, pd


@pytest.mark.parametrize("impl", ["segment", "gather_scatter"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_reference(case, impl):
    jd, pd = _run_both(case, impl)
    factors, lmbda, fit_value = convert.decomp_to_numpy(pd)
    assert np.isfinite(fit_value) and 0.0 < fit_value < 1.0
    np.testing.assert_allclose(fit_value, float(jd.fit), atol=1e-4)
    for a, b in zip(factors, jd.factors):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lmbda, np.asarray(jd.lmbda), rtol=1e-2)


def _port_run(impl="segment", niters=6, **kwargs):
    dims, inds, vals = paper_like("yelp", 1e-4, seed=3)
    _, pt = both_tensors(inds, vals, dims)
    _, pstate = both_states(np_factors(dims, RANK, 4))
    return pt, pstate, fit(pt, RANK, impl=impl, niters=niters, state=pstate,
                           **kwargs)


def test_cuda_impl_on_cpu_runs_the_plain_version():
    _, _, plain = _port_run("gather_scatter")
    _, _, cuda = _port_run("cuda")
    for a, b in zip(cuda.factors, plain.factors):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert float(cuda.fit) == pytest.approx(float(plain.fit), abs=1e-6)


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_fit_restores_the_callers_tf32_setting(allow_tf32):
    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    flag.allow_tf32 = allow_tf32
    try:
        _port_run(niters=1)
        assert flag.allow_tf32 is allow_tf32
    finally:
        flag.allow_tf32 = prev


@pytest.mark.parametrize("fused", [False, True])
def test_timed_paths_match_untimed(fused):
    _, _, base = _port_run()
    timers = {}
    _, _, timed = _port_run(timers=timers, fused_epilogue=fused)
    want = ROUTINES_FUSED if fused else ROUTINES
    assert set(timers) == set(want)
    assert all(v >= 0.0 for v in timers.values())
    assert float(timed.fit) == pytest.approx(float(base.fit), abs=1e-5)
    if not fused:
        assert set(EPILOGUE_ROUTINES) < set(timers)


def test_resume_matches_uninterrupted_run():
    states = []
    pt, _, full = _port_run(niters=6, checkpoint_cb=states.append)
    assert [int(s.iteration) for s in states] == [1, 2, 3, 4, 5, 6]
    assert all(isinstance(s, DecompState) for s in states)
    resumed = fit(pt, RANK, niters=6, state=states[2])
    for a, b in zip(resumed.factors, full.factors):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
    assert float(resumed.fit) == float(full.fit)


def test_tol_and_with_fit():
    _, _, early = _port_run(niters=50, tol=1e-2)
    _, _, full = _port_run(niters=50)
    assert float(early.fit) < float(full.fit)
    pt, _, resumed = _port_run(niters=2, with_fit=False)
    assert float(resumed.fit) == 0.0  # the restored state's fit
    assert np.isnan(float(fit(pt, RANK, niters=2, with_fit=False).fit))
    with pytest.raises(ValueError, match="tol"):
        _port_run(niters=2, with_fit=False, tol=1e-3)


def test_monitor_and_verbose_line(capsys):
    class Monitor:
        def __init__(self):
            self.times, self.checks = [], 0

        def record(self, host, seconds):
            self.times.append((host, seconds))

        def check(self):
            self.checks += 1

    mon = Monitor()
    _port_run(niters=3, monitor=mon, verbose=True)
    assert len(mon.times) == 3 and mon.checks == 3
    assert all(h == 0 and s > 0 for h, s in mon.times)
    lines = capsys.readouterr().out.splitlines()
    pattern = r"  its = \d+  fit = \d\.\d{6}  delta = [+-]\d\.\d{3}e[+-]\d\d"
    assert len(lines) == 3 and all(re.fullmatch(pattern, ln) for ln in lines)


def test_decomp_reconstruction_matches_reference():
    factors = np_factors((5, 4, 3), 3, 7)
    lmbda = np.array([1.0, 2.0, 0.5], np.float32)
    jd = JaxCPDecomp(tuple(jnp.asarray(a) for a in factors),
                     jnp.asarray(lmbda), jnp.asarray(0.5))
    pd = CPDecomp(tuple(torch.from_numpy(a) for a in factors),
                  torch.from_numpy(lmbda), torch.tensor(0.5))
    inds, _ = np_coo((5, 4, 3), 20, 8)
    np.testing.assert_allclose(pd.values_at(torch.from_numpy(inds)).numpy(),
                               np.asarray(jd.values_at(jnp.asarray(inds))),
                               rtol=1e-6)
    np.testing.assert_allclose(pd.to_dense().numpy(),
                               np.asarray(jd.to_dense()), rtol=1e-6)
    assert pd.rank == 3


def test_method_registry_and_driver_errors():
    assert available_methods() == ("cp_als",)
    assert get_method("cp_als").state_aux == ("lmbda",)
    with pytest.raises(ValueError, match="unknown method"):
        get_method("tucker_hooi")
    with pytest.raises(TypeError, match="materialized"):
        fit("data.tns", RANK)
    state = make_state([torch.ones(2, 2)], {"lmbda": torch.ones(2)},
                       torch.tensor(0.0), torch.tensor(0.0), 3)
    assert int(state.iteration) == 3 and state.iteration.dtype == torch.int32
    dims, inds, vals = paper_like("yelp", 1e-5)
    _, pt = both_tensors(inds, vals, dims)
    plan = plan_decomposition(pt, "segment")
    lin_plan = plan.__class__(
        modes=tuple(p.__class__(**{**p.__dict__, "layout": "lin"})
                    for p in plan.modes),
        policy="linearized", backend="cpu", rank=RANK)
    with pytest.raises(NotImplementedError, match="lin"):
        build_workspace(pt, lin_plan)
    with pytest.raises(NotImplementedError, match="ingested"):
        fit(object.__new__(type("Ingested", (), {"order": 3})), RANK)
    with pytest.raises(TypeError, match="CPALSState"):
        fit(pt, RANK, state={"factors": ()})


def test_state_from_numpy_matches_reference_state():
    factors = np_factors((5, 4, 3), 2, 9)
    jstate, pstate = both_states(factors)
    assert isinstance(pstate, CPALSState) and int(pstate.iteration) == 0
    for a, b in zip(pstate.factors, jstate.factors):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
