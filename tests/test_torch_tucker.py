"""The port's Tucker HOOI against the JAX package's, on the same numpy
inputs and the same initial factors.

The tensor is a fully observed planted low-rank one, as the reference's
``lowrank`` fixture (``tests/test_methods.py``), made with numpy; both
sides start from the same orthonormal factors (a numpy QR, passed as an
iteration-0 ``state=``).  The ranks are unequal.  SVD column signs are not
unique, so the factors are compared as subspaces (``U U^T``) and the model
by its reconstructed values, never as raw ``U`` or ``core``.  Tolerances:
the fit after every sweep 1e-5, the values and the subspaces 1e-4 (float32
sums in another order, then an SVD).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.methods import make_state as jax_make_state
from repro.methods import tucker_hooi as jax_tucker_hooi
from repro.methods.tucker_hooi import TuckerDecomp as JaxTuckerDecomp
from repro.methods.tucker_hooi import _resolve_ranks as jax_resolve_ranks
from repro_torch import convert
from repro_torch.methods import (DecompState, TuckerDecomp, fit, get_method,
                                 tucker_hooi)
from repro_torch.methods.tucker_hooi import (_init_orthonormal,
                                             _kron_widths, _resolve_ranks)

from test_torch_helpers import both_tensors, planted

CASES = {3: ((12, 10, 8), 4, (2, 3, 4)), 4: ((8, 7, 6, 5), 3, (2, 3, 2, 3))}
PORT_TO_REF = {"segment": "segment", "gather_scatter": "gather_scatter",
               "cuda": "pallas", "linearized": "linearized",
               "linearized_cuda": "linearized_pallas"}
NITERS = 5


def orthonormal(dims, ranks, seed):
    rng = np.random.default_rng(seed)
    return [np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
            for d, r in zip(dims, ranks)]


@pytest.fixture(scope="module", params=[3, 4])
def problem(request):
    dims, true_rank, ranks = CASES[request.param]
    inds, vals = planted(dims, true_rank, request.param)
    jt, pt = both_tensors(inds, vals, dims)
    return dict(dims=dims, ranks=ranks, inds=inds, jt=jt, pt=pt,
                init=orthonormal(dims, ranks, 10 + request.param))


def _port_state(init):
    return convert.tucker_state_from_numpy(init, 0.0, 0, "cpu")


def _run_port(problem, impl, niters=NITERS, **kw):
    fits = []
    dec = fit(problem["pt"], problem["ranks"], method="tucker_hooi",
              impl=impl, niters=niters, state=_port_state(problem["init"]),
              checkpoint_cb=lambda s: fits.append(float(s.fit)), **kw)
    return dec, fits


@pytest.mark.parametrize("impl", list(PORT_TO_REF))
def test_tucker_hooi_matches_reference(problem, impl):
    jfits = []
    zero = jnp.float32(0.0)
    jd = jax_tucker_hooi(
        problem["jt"], problem["ranks"], niters=NITERS,
        impl=PORT_TO_REF[impl],
        state=jax_make_state([jnp.asarray(a) for a in problem["init"]], {},
                             zero, zero, 0),
        checkpoint_cb=lambda s: jfits.append(float(s.fit)))
    pd, pfits = _run_port(problem, impl)
    assert isinstance(pd, TuckerDecomp) and pd.ranks == problem["ranks"]
    assert len(pfits) == len(jfits) == NITERS
    np.testing.assert_allclose(pfits, jfits, atol=1e-5)
    assert float(pd.fit) == pytest.approx(float(jd.fit), abs=1e-5)
    inds = problem["inds"]
    np.testing.assert_allclose(
        pd.values_at(torch.from_numpy(inds)).numpy(),
        np.asarray(jd.values_at(jnp.asarray(inds))), rtol=1e-4, atol=1e-4)
    for m, (a, b) in enumerate(zip(pd.factors, jd.factors)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, atol=1e-4,
                                   err_msg=f"mode {m} subspace")
    assert tuple(pd.core.shape) == problem["ranks"]
    # the kernels on the card take contiguous factors only
    assert all(a.is_contiguous() for a in pd.factors)


def test_fit_never_falls_across_sweeps(problem):
    """HOOI's ||core|| does not fall across sweeps; at the plateau the thin
    SVD's rotation puts float32 noise of about 1e-6 on it, so the bound is
    the reference's (``test_monotone_nondecreasing_fit_hooi``), 1e-5."""
    for impl in ("segment", "cuda"):
        _, fits = _run_port(problem, impl, niters=12)
        for a, b in zip(fits, fits[1:]):
            assert b >= a - 1e-5, (impl, fits)
        assert 0.5 < fits[-1] <= 1.0


def test_resume_from_checkpoint_is_bit_exact(problem):
    states = []
    full = fit(problem["pt"], problem["ranks"], method="tucker_hooi",
               niters=6, state=_port_state(problem["init"]),
               checkpoint_cb=states.append)
    assert [int(s.iteration) for s in states] == list(range(1, 7))
    assert all(isinstance(s, DecompState) and s.aux == {} for s in states)
    resumed = fit(problem["pt"], problem["ranks"], method="tucker_hooi",
                  niters=6, state=states[2])
    for a, b in zip(resumed.factors, full.factors):
        assert torch.equal(a, b)
    assert torch.equal(resumed.core, full.core)
    assert float(resumed.fit) == float(full.fit)
    # resumed at niters: one more TTMc recovers the core
    again = fit(problem["pt"], problem["ranks"], method="tucker_hooi",
                niters=6, state=states[-1])
    assert torch.equal(again.core, full.core)
    assert float(again.fit) == float(full.fit)


def test_fit_through_the_driver_every_policy(problem):
    seg, _ = _run_port(problem, "segment")
    for impl in ("auto", "gather_scatter", "linearized"):
        dec, _ = _run_port(problem, impl)
        assert float(dec.fit) == pytest.approx(float(seg.fit), abs=1e-5)
    spec = get_method("tucker_hooi")
    assert (spec.family, spec.kernel, spec.monotone_fit,
            spec.supports_dist) == ("tucker", "ttmc", True, False)
    timers = {}
    tucker_hooi(problem["pt"], problem["ranks"], niters=2, impl="segment",
                state=_port_state(problem["init"]), timers=timers)
    assert set(timers) == {"sort", "ttmc", "svd", "fit"}
    assert all(v >= 0.0 for v in timers.values())


def test_generator_draws_the_initial_factors(problem):
    a = tucker_hooi(problem["pt"], problem["ranks"], niters=2, generator=3)
    b = tucker_hooi(problem["pt"], problem["ranks"], niters=2,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.core, b.core)
    assert 0.0 < float(a.fit) <= 1.0


@pytest.mark.parametrize("dims,ranks", [((12, 10, 8), (2, 3, 4)),
                                        ((40, 5, 7, 9), (6, 5, 1, 3))])
def test_init_orthonormal_gives_orthonormal_columns(dims, ranks):
    fs = _init_orthonormal(dims, ranks, 0, torch.float32, "cpu")
    for f, d, r in zip(fs, dims, ranks):
        assert f.shape == (d, r) and f.dtype == torch.float32
        assert f.is_contiguous()
        torch.testing.assert_close(f.T @ f, torch.eye(r), rtol=0, atol=1e-5)
    again = _init_orthonormal(dims, ranks, 0, torch.float32, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(fs, again))


@pytest.mark.parametrize("rank", [(99, 4, 4), (4, 4), (4, 4, 4, 4),
                                  (3, 30, 3)])
def test_resolve_ranks_errors_match_reference(rank):
    dims = (12, 10, 8)
    with pytest.raises(ValueError) as want:
        jax_resolve_ranks(rank, dims)
    with pytest.raises(ValueError) as got:
        _resolve_ranks(rank, dims)
    assert str(got.value) == str(want.value)


def test_resolve_ranks_and_widths():
    assert _resolve_ranks(9, (12, 10, 8)) == (9, 9, 8)
    assert _resolve_ranks((2, 3, 4), (12, 10, 8)) == (2, 3, 4)
    assert _kron_widths((2, 3, 4)) == (12, 8, 6)
    assert _kron_widths((2, 3, 2, 3)) == (18, 12, 18, 12)


def test_decomp_reconstruction_matches_reference():
    rng = np.random.default_rng(5)
    core = rng.standard_normal((2, 3, 4)).astype(np.float32)
    fs = orthonormal((6, 5, 7), (2, 3, 4), 6)
    jd = JaxTuckerDecomp(jnp.asarray(core), tuple(jnp.asarray(a) for a in fs),
                         jnp.float32(0.5))
    pd = TuckerDecomp(torch.from_numpy(core),
                      tuple(torch.from_numpy(a) for a in fs),
                      torch.tensor(0.5))
    np.testing.assert_allclose(pd.to_dense().numpy(),
                               np.asarray(jd.to_dense()), rtol=1e-5,
                               atol=1e-6)
    inds = np.stack([rng.integers(0, d, 30) for d in (6, 5, 7)],
                    1).astype(np.int32)
    np.testing.assert_allclose(pd.values_at(torch.from_numpy(inds)).numpy(),
                               np.asarray(jd.values_at(jnp.asarray(inds))),
                               rtol=1e-5, atol=1e-6)
    got_core, got_factors, got_fit = convert.tucker_decomp_to_numpy(pd)
    np.testing.assert_array_equal(got_core, core)
    assert all(np.array_equal(a, b) for a, b in zip(got_factors, fs))
    assert got_fit == 0.5


def test_state_from_numpy_and_ingested_refused(problem):
    state = convert.tucker_state_from_numpy(problem["init"], 0.25, 3, "cpu")
    assert isinstance(state, DecompState) and state.aux == {}
    assert int(state.iteration) == 3 and float(state.fit_prev) == 0.25
    for a, b in zip(state.factors, problem["init"]):
        np.testing.assert_array_equal(a.numpy(), b)
    # an object that only looks like an Ingested handle is refused
    with pytest.raises(TypeError, match="SparseTensor or repro_torch.ingest"):
        tucker_hooi(object.__new__(type("Ingested", (), {"order": 3})),
                    (2, 2, 2))
