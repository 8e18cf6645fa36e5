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
import importlib

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
from repro_torch.methods.tucker_hooi import (RANK_DEFICIENT,
                                             _init_orthonormal,
                                             _kron_widths, _resolve_ranks,
                                             _svd_left,
                                             leading_left_vectors)
from repro_torch.obs import Tracer, scoped_registry

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


# ---------------------------------------------------------------------------
# the truncation: Y's leading left subspace from the float64 Gram
# ---------------------------------------------------------------------------

def _with_spectrum(rows, width, sigma, seed, dtype=torch.float64):
    """A (rows, width) matrix with singular values ``sigma`` (descending,
    padded with zeros) and random singular vectors."""
    g = torch.Generator().manual_seed(seed)
    k = min(rows, width)
    left = torch.linalg.qr(torch.randn((rows, k), generator=g,
                                       dtype=torch.float64))[0]
    right = torch.linalg.qr(torch.randn((width, k), generator=g,
                                        dtype=torch.float64))[0]
    s = torch.zeros(k, dtype=torch.float64)
    s[:len(sigma)] = torch.as_tensor(sigma, dtype=torch.float64)[:k]
    return ((left * s) @ right.T).to(dtype)


def _energy_gap(u, y):
    """The share of ``y``'s best rank-R energy that the span of ``u``
    misses, in float64 (the benchmark judge's ``truncation_gap``)."""
    u, y = u.double(), y.double()
    captured = float(torch.sum((torch.linalg.qr(u)[0].T @ y) ** 2))
    best = float(torch.sum(torch.linalg.eigvalsh(y.T @ y)[-u.shape[1]:]))
    return abs(best - captured) / best


def _counts(registry):
    return (registry.counter("tucker.truncation.gram").value,
            registry.counter("tucker.truncation.svd").value)


@pytest.mark.parametrize("rows,width,rank", [
    (500, 64, 8), (300, 36, 16), (64, 64, 5), (1200, 256, 16),  # I >= W
    (40, 64, 8), (20, 300, 4), (17, 18, 16),                     # I < W
])
def test_truncation_spans_the_svds_leading_subspace(rows, width, rank):
    """On a random Y of either aspect the Gram route gives the thin SVD's
    leading subspace, orthonormal columns, and counts one ``gram`` a
    call."""
    y = torch.randn((rows, width), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(rows + width))
    with scoped_registry() as registry:
        u, path = leading_left_vectors(y, rank)
        assert _counts(registry) == (1.0, 0.0)
        leading_left_vectors(y, rank)
        assert _counts(registry) == (2.0, 0.0)
    assert path == "gram" and u.shape == (rows, rank)
    assert u.dtype == torch.float64 and u.is_contiguous()
    s = _svd_left(y, rank)
    torch.testing.assert_close(u @ u.T, s @ s.T, rtol=0, atol=1e-10)
    torch.testing.assert_close(u.T @ u, torch.eye(rank, dtype=u.dtype),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows,width", [(2000, 64), (48, 200)])
def test_truncation_nearly_degenerate_at_the_cut(rows, width, dtype):
    """sigma_R and sigma_R+1 a part in 1e9 apart: the subspace is barely
    defined, but the energy it captures is the best rank-R energy to
    1e-7."""
    rank = 8
    sigma = np.linspace(2.0, 1.0, 24)
    sigma[rank:] = sigma[rank - 1] * (1.0 - 1e-9) * np.linspace(1.0, 0.5, 16)
    y = _with_spectrum(rows, width, sigma, 3, dtype)
    u, path = leading_left_vectors(y, rank)
    assert path == "gram" and u.dtype == dtype
    assert _energy_gap(u, y) <= 1e-7


@pytest.mark.parametrize("rows,width", [(3000, 128), (30, 128)])
def test_truncation_orthonormal_on_a_steep_spectrum(rows, width):
    """sigma_R / sigma_1 = 1e-4 (lambda_R / lambda_1 = 1e-8, above
    ``RANK_DEFICIENT``): the Cholesky-QR pass keeps U^T U at the identity
    and the subspace is the SVD's."""
    rank = 12
    sigma = np.logspace(0, -4, rank).tolist() + [1e-5] * 8
    y = _with_spectrum(rows, width, sigma, 4)
    u, path = leading_left_vectors(y, rank)
    assert path == "gram"
    eye = torch.eye(rank, dtype=torch.float64)
    assert float((u.T @ u - eye).abs().max()) <= 1e-6
    s = _svd_left(y, rank)
    torch.testing.assert_close(u @ u.T, s @ s.T, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,width", [(5000, 256), (100, 256)])
def test_truncation_gives_contiguous_float32(rows, width):
    y = torch.randn((rows, width),
                    generator=torch.Generator().manual_seed(rows))
    u, path = leading_left_vectors(y, 16)
    assert path == "gram" and u.dtype == torch.float32
    assert u.is_contiguous() and u.stride() == (16, 1)
    s = _svd_left(y, 16)
    torch.testing.assert_close(u @ u.T, s @ s.T, rtol=0, atol=1e-5)
    assert _energy_gap(u, y) <= 1e-7


@pytest.mark.parametrize("case", ["rank_deficient", "rank_deficient_wide",
                                  "zero", "width_below_rank",
                                  "rows_at_rank", "rows_below_rank",
                                  "below_threshold"])
def test_truncation_falls_back_to_the_svd(case):
    """Where the shape leaves no cut, or the Gram is numerically
    rank-deficient, the thin SVD decides: the result is ``_svd_left``'s and
    one ``svd`` is counted."""
    rank = 8
    y = {
        "rank_deficient": lambda: _with_spectrum(400, 64, [3, 2, 1, 1, .5],
                                                 5),
        "rank_deficient_wide": lambda: _with_spectrum(30, 90, [2, 1, 1], 6),
        "zero": lambda: torch.zeros((200, 32), dtype=torch.float64),
        "width_below_rank": lambda: torch.randn((100, 6),
                                                dtype=torch.float64),
        "rows_at_rank": lambda: torch.randn((8, 50), dtype=torch.float64),
        "rows_below_rank": lambda: torch.randn((5, 50), dtype=torch.float64),
        # lambda_R / lambda_1 = 1e-12, below RANK_DEFICIENT
        "below_threshold": lambda: _with_spectrum(
            500, 40, [1.0] * (rank - 1) + [1e-6], 7),
    }[case]()
    with scoped_registry() as registry:
        u, path = leading_left_vectors(y, rank)
        assert _counts(registry) == (0.0, 1.0)
    assert path == "svd"
    assert torch.equal(u, _svd_left(y, rank)) and u.is_contiguous()


@pytest.mark.parametrize("rows,width", [(1000, 48), (30, 200)])
def test_truncation_in_row_blocks_matches_one_block(rows, width,
                                                   monkeypatch):
    """Blocks of 7 rows (a ragged last one) give the Gram route the same
    subspace, to rounding, as Y converted whole."""
    tucker = importlib.import_module("repro_torch.methods.tucker_hooi")
    y = torch.randn((rows, width),
                    generator=torch.Generator().manual_seed(rows))
    whole, path = leading_left_vectors(y, 6)
    monkeypatch.setattr(tucker, "_BLOCK_ELEMENTS", 7 * min(rows, width))
    blocked, blocked_path = leading_left_vectors(y, 6)
    assert path == blocked_path == "gram"
    torch.testing.assert_close(blocked @ blocked.T, whole @ whole.T,
                               rtol=0, atol=1e-6)


def test_truncation_falls_back_where_cholesky_fails(monkeypatch):
    """A Cholesky factorisation of U^T U that reports failure sends the
    truncation to the thin SVD (the spectrum alone would take the Gram)."""
    y = _with_spectrum(300, 32, np.linspace(3, 1, 32).tolist(), 9)
    factor = torch.linalg.cholesky_ex
    monkeypatch.setattr(torch.linalg, "cholesky_ex", lambda a: factor(-a))
    with scoped_registry() as registry:
        u, path = leading_left_vectors(y, 8)
        assert _counts(registry) == (0.0, 1.0)
    assert path == "svd" and torch.equal(u, _svd_left(y, 8))


def test_truncation_threshold_sits_between_resolved_and_deficient():
    """Just above ``RANK_DEFICIENT`` the Gram still resolves the R-th
    direction (the SVD's subspace to 1e-6, orthonormal columns); the same
    spectrum pushed below it falls back."""
    rank = 6
    for ratio, want in ((10 * RANK_DEFICIENT, "gram"),
                        (RANK_DEFICIENT / 10, "svd")):
        sigma = [1.0] * (rank - 1) + [ratio ** 0.5] + [1e-7] * 4
        y = _with_spectrum(800, 48, sigma, 8)
        u, path = leading_left_vectors(y, rank)
        assert path == want, ratio
        s = _svd_left(y, rank)
        torch.testing.assert_close(u @ u.T, s @ s.T, rtol=0, atol=1e-6)
        torch.testing.assert_close(u.T @ u, torch.eye(rank, dtype=u.dtype),
                                   rtol=0, atol=1e-6)


def test_svd_spans_carry_the_truncation_path(problem):
    """Each truncation of a traced fit runs in one ``svd`` span that says
    which path it took; the registry counts the same truncations."""
    order = len(problem["dims"])
    tracer = Tracer()
    with scoped_registry() as registry, tracer.activate():
        _run_port(problem, "segment", niters=3)
        gram, svd = _counts(registry)
    spans = [e for e in tracer.events() if e["name"] == "svd"]
    assert len(spans) == 3 * order == gram + svd
    paths = [e["args"]["path"] for e in spans]
    assert paths.count("gram") == gram and paths.count("svd") == svd
    assert {e["args"]["mode"] for e in spans} == set(range(order))
