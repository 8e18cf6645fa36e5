"""The port's method registry, nonnegative CP (HALS) and streaming CP-ALS
against the JAX package's.

The first part mirrors the HALS, streaming and registry cases of
``tests/test_methods.py`` on the port alone (the distributed gates,
``plan_report`` and the dense HOOI reference, which ``test_torch_tucker.py``
covers, are left out).  The second holds ``cp_nn_hals`` (``segment``,
``linearized``) and ``cp_als_streaming`` (decay 1 and 0.5) to the reference
from the same state: fits within 1e-4, factors and lambda within 1e-2.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.methods import cp_als_streaming as jax_cp_als_streaming
from repro.methods import fit as jax_fit
from repro.methods import make_state as jax_make_state
from repro_torch import convert
from repro_torch.core import paper_dataset, random_sparse
from repro_torch.core.cpals import CPDecomp
from repro_torch.ingest import ingest, write_tns, write_tnsb
from repro_torch.methods import (MethodSpec, available_methods,
                                 cp_als_streaming, cp_nn_hals, fit,
                                 get_method, make_state, register_method)

from test_torch_helpers import both_tensors, np_coo, np_factors, planted

SEED = 42
ALS_FAMILY = ("cp_als", "cp_nn_hals", "tucker_hooi", "cp_als_streaming")


@pytest.fixture(scope="module")
def lowrank():
    inds, vals = planted((12, 10, 8), 4, 1)
    return both_tensors(inds, vals, (12, 10, 8))[1]


def _fit_kwargs(method):
    kw = {"niters": {"cp_als": 60, "cp_als_streaming": 60,
                     "cp_nn_hals": 150, "tucker_hooi": 10}[method]}
    if get_method(method).supports_streaming:
        kw["n_chunks"] = 4
    return kw


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def test_all_four_methods_registered():
    assert available_methods() == ALS_FAMILY


def test_available_methods_filters():
    # the distributed capability is not ported: no method declares it
    assert available_methods(dist=True) == ()
    assert available_methods(streaming=True) == ("cp_als_streaming",)
    assert available_methods(nonnegative=True) == ("cp_nn_hals",)
    assert available_methods(family="tucker") == ("tucker_hooi",)


def test_get_method_unknown_lists_registry():
    with pytest.raises(ValueError, match="cp_als"):
        get_method("nope")


def test_register_method_validates():
    with pytest.raises(ValueError, match="family"):
        register_method(MethodSpec(name="x", fn=lambda: None, family="bad"))
    with pytest.raises(ValueError, match="kernel"):
        register_method(MethodSpec(name="x", fn=lambda: None, family="cp",
                                   kernel="bad"))


def test_fit_rejects_path_for_non_streaming_method():
    with pytest.raises(TypeError, match="streaming"):
        fit("nonexistent.tns", 4, method="cp_als")
    with pytest.raises(TypeError, match="chunk list"):
        fit(type("Handle", (), {"order": 3})(), 4,
            method="cp_als_streaming")


# ---------------------------------------------------------------------------
# convergence, nonnegativity, monotone fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ALS_FAMILY)
def test_methods_reach_fit_at_full_rank(lowrank, method):
    """fit >= 0.99 at full rank on a fully observed rank-4 tensor."""
    rank = (4, 4, 4) if method == "tucker_hooi" else 6
    dec = fit(lowrank, rank, method=method, generator=SEED,
              **_fit_kwargs(method))
    assert float(dec.fit) >= 0.99, (method, float(dec.fit))


def test_cp_nn_hals_factors_are_nonnegative(lowrank):
    dec = fit(lowrank, 6, method="cp_nn_hals", niters=30, generator=SEED)
    for m, a in enumerate(dec.factors):
        assert float(a.min()) >= 0.0, (m, float(a.min()))
    assert float(dec.lmbda.min()) >= 0.0
    torch.testing.assert_close(torch.linalg.norm(dec.factors[0], dim=0),
                               torch.ones(6), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["cp_als", "cp_nn_hals",
                                    "cp_als_streaming"])
def test_monotone_nondecreasing_fit(lowrank, method):
    fits = []
    kw = {"n_chunks": 4} if get_method(method).supports_streaming else {}
    fit(lowrank, 4, method=method, niters=15, generator=SEED,
        checkpoint_cb=lambda s: fits.append(float(s.fit)), **kw)
    assert len(fits) == 15
    for a, b in zip(fits, fits[1:]):
        assert b >= a - 1e-6, fits


def test_monotone_nondecreasing_fit_hooi(lowrank):
    fits = []
    fit(lowrank, (3, 3, 3), method="tucker_hooi", niters=15, generator=SEED,
        checkpoint_cb=lambda s: fits.append(float(s.fit)))
    assert len(fits) == 15
    for a, b in zip(fits, fits[1:]):
        assert b >= a - 1e-5, fits


def test_hals_timed_path_matches_untimed(lowrank):
    """``timers=`` adds sort/mttkrp/epilogue seconds and changes no bit."""
    timers = {}
    timed = cp_nn_hals(lowrank, 4, niters=3, generator=SEED, timers=timers)
    plain = cp_nn_hals(lowrank, 4, niters=3, generator=SEED)
    assert set(timers) == {"sort", "mttkrp", "epilogue"}
    assert all(v > 0.0 for v in timers.values())
    for a, b in zip(timed.factors, plain.factors):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("impl,plain_impl", [("cuda", "segment"),
                                             ("linearized_cuda",
                                              "linearized")])
def test_hals_cuda_impls_on_cpu_run_the_plain_versions(lowrank, impl,
                                                       plain_impl):
    plain = cp_nn_hals(lowrank, 4, niters=3, generator=SEED, impl=plain_impl)
    got = cp_nn_hals(lowrank, 4, niters=3, generator=SEED, impl=impl)
    assert float(got.fit) == pytest.approx(float(plain.fit), abs=1e-6)
    for a, b in zip(got.factors, plain.factors):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_hals_tol_stops_early(lowrank):
    fits = []
    cp_nn_hals(lowrank, 6, niters=150, tol=1e-3, generator=SEED,
               checkpoint_cb=lambda s: fits.append(float(s.fit)))
    assert 1 < len(fits) < 150


# ---------------------------------------------------------------------------
# streaming vs batch
# ---------------------------------------------------------------------------

def test_streaming_matches_batch_on_paper_tensor():
    """cp_als_streaming over 4 chunks == batch cp_als fit within 1e-3 on the
    scaled paper tensor (the reference's acceptance contract)."""
    t = paper_dataset("yelp", 3, scale=0.002, device="cpu")
    batch = fit(t, 8, niters=10, impl="gather_scatter", generator=3)
    streamed = cp_als_streaming(t, 8, niters=10, n_chunks=4, generator=3)
    assert abs(float(streamed.fit) - float(batch.fit)) < 1e-3, (
        float(streamed.fit), float(batch.fit))


def test_streaming_from_tns_path(tmp_path, lowrank):
    p = tmp_path / "t.tns"
    write_tns(p, lowrank)
    dec = cp_als_streaming(str(p), 6, niters=40, chunk_nnz=257,
                           generator=SEED, device="cpu")
    assert float(dec.fit) > 0.98, float(dec.fit)


def test_streaming_from_tnsb_through_fit(tmp_path, lowrank):
    """The driver hands a ``.tnsb`` path to the streaming method; the fit is
    the in-memory split's, bit for bit (the same chunks in the same
    order)."""
    p = tmp_path / "t.tnsb"
    write_tnsb(p, lowrank)
    from_file = fit(p, 4, method="cp_als_streaming", niters=5,
                    chunk_nnz=300, generator=SEED, device="cpu")
    in_memory = fit(lowrank, 4, method="cp_als_streaming", niters=5,
                    chunk_nnz=300, generator=SEED)
    assert float(from_file.fit) == float(in_memory.fit)


def test_streaming_rejects_sorted_impls(lowrank):
    with pytest.raises(ValueError, match="sorted workspace"):
        cp_als_streaming(lowrank, 4, impl="segment")
    from repro_torch.plan import plan_decomposition

    with pytest.raises(ValueError, match="cannot execute plan"):
        cp_als_streaming(lowrank, 4, plan=plan_decomposition(lowrank,
                                                             "segment"))


def test_streaming_decay_validates(lowrank):
    with pytest.raises(ValueError, match="decay"):
        cp_als_streaming(lowrank, 4, decay=1.5)
    with pytest.raises(ValueError, match="decay"):
        cp_als_streaming(lowrank, 4, decay=0.0)


def test_streaming_decay_fold_discounts_old_chunks(lowrank):
    dec = cp_als_streaming(lowrank, 6, niters=40, n_chunks=4, decay=0.99,
                           generator=SEED)
    assert np.isfinite(float(dec.fit))
    assert float(dec.fit) > 0.7, float(dec.fit)


def test_ingested_roundtrip_through_fit(lowrank):
    """Ingested handles flow through fit() for every method, streaming
    included, and factors come back in the original labels."""
    ing = ingest(lowrank, reorder="degree_sort")
    for method in ALS_FAMILY:
        rank = (3, 3, 3) if method == "tucker_hooi" else 4
        dec = fit(ing, rank, method=method, niters=3, generator=SEED)
        assert dec.factors[0].shape[0] == lowrank.dims[0]
        vals = dec.values_at(lowrank.inds[:8]).numpy()
        assert np.all(np.isfinite(vals))


def test_streaming_ingested_restores_labels(lowrank):
    """Streaming an ingested (reordered) handle equals streaming the tensor
    itself from the same state, in the original labels."""
    ing = ingest(lowrank, reorder="degree_sort")
    rel = ing.relabeling
    f0 = tuple(torch.from_numpy(a) for a in np_factors(lowrank.dims, 4, 2))
    z = torch.tensor(0.0)

    def state(factors):
        return make_state(factors, {"lmbda": torch.ones(4)}, z, z, 0)

    dec_ing = fit(ing, 4, method="cp_als_streaming", niters=4,
                  state=state(rel.apply_factors(f0)), n_chunks=1)
    dec_nat = fit(lowrank, 4, method="cp_als_streaming", niters=4,
                  state=state(f0), n_chunks=1)
    assert abs(float(dec_ing.fit) - float(dec_nat.fit)) < 1e-5
    for a, b in zip(dec_ing.factors, dec_nat.factors):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# against the JAX package, from the same state
# ---------------------------------------------------------------------------

def _yelp_like(seed=0):
    dims = (60, 40, 70)
    inds, vals = np_coo(dims, 3000, seed, skew=1.5)
    return dims, both_tensors(inds, vals, dims)


def _same_state(dims, rank, seed, *, lmbda):
    factors = np_factors(dims, rank, seed)
    zero = np.float32(0.0)
    aux = {"lmbda": np.ones(rank, np.float32)} if lmbda else {}
    jstate = jax_make_state([jnp.asarray(a) for a in factors],
                            {k: jnp.asarray(v) for k, v in aux.items()},
                            jnp.asarray(zero), jnp.asarray(zero), 0)
    pstate = make_state([torch.from_numpy(a) for a in factors],
                        {k: torch.from_numpy(v) for k, v in aux.items()},
                        torch.tensor(zero), torch.tensor(zero), 0)
    return jstate, pstate


def _assert_cp_close(pd: CPDecomp, jd, what):
    factors, lmbda, fit_value = convert.decomp_to_numpy(pd)
    assert np.isfinite(fit_value) and 0.0 < fit_value < 1.0, what
    assert abs(fit_value - float(jd.fit)) < 1e-4, (what, fit_value,
                                                   float(jd.fit))
    for a, b in zip(factors, jd.factors):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=1e-2,
                                   err_msg=what)
    np.testing.assert_allclose(lmbda, np.asarray(jd.lmbda), rtol=1e-2,
                               err_msg=what)


@pytest.mark.parametrize("impl", ["segment", "linearized"])
def test_hals_matches_reference(impl):
    dims, (jt, pt) = _yelp_like()
    jstate, pstate = _same_state(dims, 6, 1, lmbda=False)
    jd = jax_fit(jt, 6, method="cp_nn_hals", impl=impl, niters=12,
                 state=jstate)
    pd = fit(pt, 6, method="cp_nn_hals", impl=impl, niters=12, state=pstate)
    _assert_cp_close(pd, jd, f"hals {impl}")
    assert all(float(a.min()) >= 0.0 for a in pd.factors)


@pytest.mark.parametrize("decay", [1.0, 0.5])
def test_streaming_matches_reference(decay):
    dims, (jt, pt) = _yelp_like(1)
    jstate, pstate = _same_state(dims, 6, 2, lmbda=True)
    jd = jax_cp_als_streaming(jt, 6, niters=8, n_chunks=3, decay=decay,
                              state=jstate)
    pd = cp_als_streaming(pt, 6, niters=8, n_chunks=3, decay=decay,
                          state=pstate)
    _assert_cp_close(pd, jd, f"streaming decay={decay}")


def test_streaming_from_reference_written_tnsb(tmp_path):
    """A ``.tnsb`` the reference wrote streams in the port to the
    reference's own streamed fit, from the same state."""
    import repro.ingest as jax_ingest

    dims, (jt, pt) = _yelp_like(2)
    p = tmp_path / "x.tnsb"
    jax_ingest.write_tnsb(p, jt)
    jstate, pstate = _same_state(dims, 5, 3, lmbda=True)
    jd = jax_cp_als_streaming(str(p), 5, niters=6, chunk_nnz=1000,
                              state=jstate)
    pd = fit(p, 5, method="cp_als_streaming", niters=6, chunk_nnz=1000,
             state=pstate, device="cpu")
    _assert_cp_close(pd, jd, "streaming from a reference .tnsb")
    assert not math.isnan(float(pd.fit))


def test_order4_hals_and_streaming():
    t = random_sparse((9, 8, 7, 6), 400, SEED, device="cpu")
    for method in ("cp_nn_hals", "cp_als_streaming"):
        dec = fit(t, 3, method=method, niters=3, generator=SEED)
        assert [tuple(a.shape) for a in dec.factors] == [
            (9, 3), (8, 3), (7, 3), (6, 3)]
        assert 0.0 <= float(dec.fit) <= 1.0
