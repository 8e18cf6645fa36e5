"""The port's linearized (ALTO-style) workspace, its MTTKRP impls and the
measured planner (calibration + autotune store) against the JAX package's,
on the same numpy inputs.

Words are compared as uint32 bit patterns (the port stores them as int32);
MTTKRP is held at 2e-4 (``tests/test_linearized.py``'s tolerance) and at
5e-2 in bfloat16; the fits at 1e-4 and the factors at 1e-2, as in
``tests/test_torch_cpals.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.linearized as jlinmod
from repro.core import mttkrp as jax_mttkrp
from repro.ingest.cache import content_key as jax_content_key
from repro.kernels import ops as jops
from repro.methods import fit as jax_fit
from repro.plan import plan_decomposition as jax_plan
from repro.plan import planner as jax_planner
from repro_torch import convert
from repro_torch.core import (Linearized, SparseTensor, available_impls,
                              build_workspace, mttkrp)
from repro_torch.core import linearized as plinmod
from repro_torch.core.coo import PAPER_DATASETS
from repro_torch.ingest import content_key, write_tnsb
from repro_torch.kernels import ref
from repro_torch.methods import fit
from repro_torch.plan import (AutotuneStore, calibration_key,
                              plan_decomposition, registry_fingerprint)
from repro_torch.plan import planner as planner_mod

from test_torch_helpers import both_states, both_tensors, np_coo, np_factors

DIMS3 = (23, 17, 31)
DIMS4 = (23, 17, 31, 11)


def _tensors(dims, nnz=500, seed=0, skew=0.0):
    inds, vals = np_coo(dims, nnz, seed, skew=skew)
    return both_tensors(inds, vals, dims)


def _empty_tile_tensors():
    """Mode 0 rows only in [0, 40) and [160, 200): with row_tile 16 the
    tiles 3..9 hold no entry and get one block of padding each."""
    dims = (200, 7, 5)
    inds, vals = np_coo(dims, 600, 5)
    keep = (inds[:, 0] < 40) | (inds[:, 0] >= 160)
    return both_tensors(inds[keep], vals[keep], dims)


def _words(x) -> np.ndarray:
    """Packed words as uint32 bit patterns, from either package."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint32)


# ---------------------------------------------------------------------------
# packing layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [DIMS3, DIMS4, (1, 2, 1024),
                                  (41_000, 11_000, 75_000), (2**32, 2, 2)])
def test_widths_offsets_and_budget_match_reference(dims):
    assert plinmod.bit_widths(dims) == jlinmod.bit_widths(dims)
    assert plinmod.check_bit_budget(dims) == jlinmod.check_bit_budget(dims)
    for sm in range(len(dims)):
        assert (plinmod.field_offsets(dims, sm)
                == jlinmod.field_offsets(dims, sm))


def test_yelp_offsets_straddle_the_words():
    dims = PAPER_DATASETS["yelp"][0]
    assert plinmod.bit_widths(dims) == (16, 14, 17)
    assert plinmod.field_offsets(dims, 0) == (31, 17, 0)
    assert plinmod.field_offsets(dims, 1) == (17, 33, 0)


@pytest.mark.parametrize("dims", [(2**40, 2**31, 4), (2**33, 2, 2),
                                  (2**22, 2**22, 2**22)])
def test_overflow_errors_match_reference(dims):
    with pytest.raises(ValueError) as want:
        jlinmod.check_bit_budget(dims)
    with pytest.raises(ValueError) as got:
        plinmod.check_bit_budget(dims)
    assert str(got.value) == str(want.value)
    inds = np.zeros((3, 3), np.int32)
    with pytest.raises(ValueError, match="budget"):
        plinmod.build_linearized(SparseTensor(inds, np.ones(3, np.float32),
                                              dims, 3, device="cpu"))


@pytest.mark.parametrize("dims", [DIMS3, DIMS4])
def test_linearize_roundtrip_every_sort_mode(dims):
    inds, _ = np_coo(dims, 400, 1)
    for sm in range(len(dims)):
        lin = plinmod.linearize_coords(inds, dims, sm)
        np.testing.assert_array_equal(
            lin, jlinmod.linearize_coords(inds, dims, sm))
        np.testing.assert_array_equal(
            plinmod.delinearize_coords(lin, dims, sm), inds.astype(np.int64))


# (offset, width): fields in hi only, in lo only, and straddling the words,
# with widths up to 32
DECODE_FIELDS = (
    [(32, 5), (40, 24), (33, 31), (32, 32), (63, 1)]
    + [(0, 32), (0, 5), (10, 22), (31, 1), (7, 16)]
    + [(31, 16), (20, 32), (1, 32), (17, 30), (28, 8), (31, 32)])


@pytest.mark.parametrize("offset,width", DECODE_FIELDS)
def test_decode_field_bit_for_bit(offset, width):
    rng = np.random.default_rng(offset * 64 + width)
    hi = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    hi[::2] |= np.uint32(0x80000000)  # top bit set in half of each word
    lo[::3] |= np.uint32(0x80000000)
    want = np.asarray(jlinmod.decode_field(jnp.asarray(hi), jnp.asarray(lo),
                                           offset, width))
    got = plinmod.decode_field(torch.from_numpy(hi.view(np.int32)),
                               torch.from_numpy(lo.view(np.int32)),
                               offset, width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# ---------------------------------------------------------------------------
# the build: one sort, CSF-style padding, entry for entry
# ---------------------------------------------------------------------------

BUILD_CASES = ([(DIMS3, sm, 64, 16) for sm in range(3)]
               + [(DIMS4, sm, 64, 16) for sm in range(4)]
               + [(DIMS3, 0, 512, 128)])


@pytest.mark.parametrize("dims,sort_mode,block,row_tile", BUILD_CASES)
def test_build_matches_reference(dims, sort_mode, block, row_tile):
    jt, pt = _tensors(dims, nnz=700, seed=sort_mode, skew=1.0)
    _assert_same_build(jt, pt, sort_mode, block, row_tile)


def test_build_with_empty_tiles_matches_reference():
    jt, pt = _empty_tile_tensors()
    plin = _assert_same_build(jt, pt, 0, 32, 16)
    assert plin.num_row_tiles == 13 and plin.num_blocks > 13


def _assert_same_build(jt, pt, sort_mode, block, row_tile) -> Linearized:
    jlin = jlinmod.build_linearized(jt, block=block, row_tile=row_tile,
                                    sort_mode=sort_mode)
    plin = plinmod.build_linearized(pt, block=block, row_tile=row_tile,
                                    sort_mode=sort_mode)
    for name in ("hi", "lo"):
        assert getattr(plin, name).dtype == torch.int32
        np.testing.assert_array_equal(_words(getattr(plin, name)),
                                      _words(getattr(jlin, name)))
    np.testing.assert_array_equal(plin.vals.numpy(), np.asarray(jlin.vals))
    np.testing.assert_array_equal(plin.block_tile.numpy(),
                                  np.asarray(jlin.block_tile))
    for prop in ("widths", "offsets", "num_rows", "num_row_tiles",
                 "padded_nnz", "num_blocks", "padding_overhead"):
        assert getattr(plin, prop) == getattr(jlin, prop), prop
    for m in range(plin.order):
        np.testing.assert_array_equal(plin.decode(m).numpy(),
                                      np.asarray(jlin.decode(m)))
    return plin


def _by_value(jlin) -> Linearized:
    """The reference's workspace handed to the port as numpy arrays."""
    return convert.linearized_from_numpy(
        np.asarray(jlin.hi), np.asarray(jlin.lo), np.asarray(jlin.vals),
        np.asarray(jlin.block_tile), jlin.dims, jlin.nnz, jlin.block,
        jlin.row_tile, jlin.sort_mode, "cpu")


# ---------------------------------------------------------------------------
# MTTKRP over the workspace: both impls, every mode, order 3 and 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,ref_impl", [("linearized", "linearized"),
                                           ("linearized_cuda",
                                            "linearized_pallas")])
@pytest.mark.parametrize("dims", [DIMS3, DIMS4])
def test_mttkrp_impls_match_reference_every_mode(dims, impl, ref_impl):
    jt, _ = _tensors(dims, seed=2, skew=0.5)
    jlin = jlinmod.build_linearized(jt, block=64, row_tile=16)
    plin = _by_value(jlin)
    fs = np_factors(dims, 6, 3)
    pf = tuple(torch.from_numpy(a) for a in fs)
    jf = tuple(jnp.asarray(a) for a in fs)
    for mode in range(len(dims)):
        got = mttkrp(plin, pf, mode, impl=impl)
        want = jax_mttkrp(jlin, jf, mode, impl=ref_impl)
        assert got.shape == (dims[mode], 6) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"{impl} mode {mode}")


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4),
                                       (jnp.bfloat16, 5e-2)])
@pytest.mark.parametrize("sort_mode", [0, 1, 2])
def test_plain_kernel_matches_reference_ops(sort_mode, dtype, tol):
    jt, _ = _tensors(DIMS3, nnz=800, seed=4, skew=1.0)
    jlin = jlinmod.build_linearized(jt, block=64, row_tile=16,
                                    sort_mode=sort_mode)
    plin = _by_value(jlin)
    fs = np_factors(DIMS3, 8, 5)
    jf = tuple(jnp.asarray(a).astype(dtype) for a in fs)
    pf = tuple(torch.from_numpy(np.array(a.astype(jnp.float32)))
               .to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
               for a in jf)
    want = np.asarray(jops.mttkrp_lin(jlin, jf, sort_mode).astype(
        jnp.float32))
    got = ref.mttkrp_lin_ref(plin, pf, sort_mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_linearized_impls_reject_other_workspaces():
    _, pt = _tensors(DIMS3)
    f = tuple(torch.from_numpy(a) for a in np_factors(DIMS3, 3, 0))
    for impl in ("linearized", "linearized_cuda"):
        with pytest.raises(TypeError, match="Linearized workspace"):
            mttkrp(pt, f, 0, impl=impl)


# ---------------------------------------------------------------------------
# planner: predicted costs, layout, budget gate, calibration, the store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,nnz,skew", [(DIMS3, 600, 0.0),
                                           ((300, 200, 100), 6000, 1.5),
                                           (DIMS4, 900, 1.0)])
def test_predicted_cost_tables_match_reference(dims, nnz, skew):
    jt, pt = _tensors(dims, nnz=nnz, seed=6, skew=skew)
    jp = jax_plan(jt, "auto", rank=8, backend="cpu")
    pp = plan_decomposition(pt, "auto", rank=8)
    assert pp.impls == jp.impls
    for p, j in zip(pp.modes, jp.modes):
        assert "linearized" in p.costs
        assert set(p.costs) == set(j.costs)
        assert tuple(p.costs) == tuple(j.costs)  # one canonical order
        for name, cost in p.costs.items():
            assert cost == pytest.approx(j.costs[name], rel=1e-12)
        assert p.source == j.source == "predicted"


def test_fixed_linearized_plan_shares_one_workspace():
    _, pt = _tensors(DIMS3)
    plan = plan_decomposition(pt, "linearized", rank=4)
    assert plan.layouts == ("lin",) * 3
    ws = build_workspace(pt, plan)
    assert all(isinstance(w, Linearized) for w in ws)
    assert all(w is ws[0] for w in ws)


def test_budget_gate_drops_lin_candidates():
    names = available_impls(order=3, backend="cuda")
    assert {"linearized", "linearized_cuda"} <= set(names)
    huge = SparseTensor(np.zeros((3, 3), np.int32), np.ones(3, np.float32),
                        (2**40, 2**31, 4), 3, device="cpu")
    kept = planner_mod._fits_lin_budget(huge, names)
    assert set(kept) == {n for n in names if "linearized" not in n}
    _, pt = _tensors(DIMS3)
    assert planner_mod._fits_lin_budget(pt, names) == names


@pytest.fixture
def measure_counter(monkeypatch):
    """Counts (and still performs) every calibration timing run."""
    calls = {"n": 0}
    real = planner_mod._measure_ms

    def counting(fn, *args, **kwargs):
        calls["n"] += 1
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(planner_mod, "_measure_ms", counting)
    return calls


def test_calibrate_with_allow_times_exactly_the_allowed_set(measure_counter):
    _, pt = _tensors(DIMS3, nnz=600, seed=7)
    allow = ("segment", "gather_scatter", "linearized")
    plan = plan_decomposition(pt, "auto", rank=6, calibrate=True,
                              allow=allow)
    assert measure_counter["n"] == 3 * len(allow)
    for p in plan.modes:
        assert p.source == "measured-fresh"
        assert tuple(p.costs) == tuple(sorted(allow))
        assert all(c > 0 for c in p.costs.values())
        assert p.impl == min(p.costs, key=p.costs.get)
        assert "ms" in p.reason


def test_second_plan_on_the_store_times_nothing(tmp_path, measure_counter):
    _, pt = _tensors(DIMS3, nnz=600, seed=8, skew=1.0)
    store = AutotuneStore(tmp_path)
    first = plan_decomposition(pt, "auto", rank=6, calibrate=True,
                               autotune=store)
    cold = measure_counter["n"]
    assert cold == 3 * len(first.modes[0].costs) and store.misses == 3
    second = plan_decomposition(pt, "auto", rank=6, calibrate=True,
                                autotune=store)
    assert measure_counter["n"] == cold
    assert store.hits == 3
    assert [p.source for p in second.modes] == ["measured-cached"] * 3
    assert second.impls == first.impls
    assert [p.costs for p in second.modes] == [p.costs for p in first.modes]
    # a path roots its own store over the same files
    third = plan_decomposition(pt, "auto", rank=6, calibrate=True,
                               autotune=str(tmp_path))
    assert measure_counter["n"] == cold and third.impls == first.impls
    fresh = plan_decomposition(pt, "auto", rank=6, calibrate=True,
                               autotune=store, recalibrate=True)
    assert measure_counter["n"] == 2 * cold
    assert [p.source for p in fresh.modes] == ["measured-fresh"] * 3


def test_fixed_policy_calibration_is_cached(tmp_path, measure_counter):
    _, pt = _tensors(DIMS3, nnz=500, seed=9)
    plan = plan_decomposition(pt, "linearized", rank=4, calibrate=True,
                              autotune=tmp_path)
    assert measure_counter["n"] == 3
    assert all(set(p.costs) == {"linearized"} for p in plan.modes)
    again = plan_decomposition(pt, "linearized", rank=4, calibrate=True,
                               autotune=tmp_path)
    assert measure_counter["n"] == 3
    assert [p.source for p in again.modes] == ["measured-cached"] * 3


def test_calibration_key_separates_every_axis():
    base = dict(mode=0, names=("segment", "linearized"), backend="cuda",
                rank=8, block=512, row_tile=128)
    key = calibration_key("t", **base)
    assert key == calibration_key(
        "t", **{**base, "names": ("linearized", "segment")})
    for change in ({"mode": 1}, {"names": ("segment",)}, {"backend": "cpu"},
                   {"rank": 9}, {"block": 256}, {"row_tile": 64},
                   {"stats_digest": "x"}):
        assert calibration_key("t", **{**base, **change}) != key
    assert calibration_key("u", **base) != key
    assert len(registry_fingerprint("mttkrp")) == 16
    # the TTMc registry is a key axis of its own
    assert registry_fingerprint("ttmc") != registry_fingerprint("mttkrp")
    assert calibration_key("t", kernel="ttmc", **base) != key


def test_store_roundtrip_counters_and_version(tmp_path):
    store = AutotuneStore(tmp_path)
    assert store.load("ab" * 32) is None and store.misses == 1
    store.store("ab" * 32, {"segment": 1.5}, meta={"mode": 0})
    assert store.has("ab" * 32)
    payload = store.load("ab" * 32)
    assert payload["costs"] == {"segment": 1.5} and store.hits == 1
    path = tmp_path / "ab" / f"{'ab' * 32}.json"
    path.write_text(path.read_text().replace('"version": 1',
                                             '"version": 0'))
    assert store.load("ab" * 32) is None and not path.exists()


def test_calibrating_ttmc_is_refused(measure_counter):
    """Refused without the Tucker ranks (the reference's text); with
    ``factor_ranks`` every TTMc candidate of every mode is timed."""
    jt, pt = _tensors(DIMS3)
    with pytest.raises(ValueError) as want:
        jax_planner._calibrate_mode(jt, 0, ("segment",), rank=4, block=64,
                                    row_tile=16, kernel="ttmc")
    with pytest.raises(ValueError) as got:
        planner_mod._calibrate_mode(pt, 0, ("segment",), rank=4, block=64,
                                    row_tile=16, kernel="ttmc")
    assert str(got.value) == str(want.value)
    assert measure_counter["n"] == 0
    plan = plan_decomposition(pt, "auto", rank=(6, 4, 3), kernel="ttmc",
                              factor_ranks=(1, 2, 3), calibrate=True)
    names = ("gather_scatter", "linearized", "segment")
    assert measure_counter["n"] == 3 * len(names)
    for p in plan.modes:
        assert p.kernel == "ttmc" and p.source == "measured-fresh"
        assert tuple(p.costs) == names
        assert all(c > 0 for c in p.costs.values())
        assert p.impl == min(p.costs, key=p.costs.get)


@pytest.mark.parametrize("kwargs", [{}, {"reorder": "degree_sort",
                                         "dims": (30, 20, 40)},
                                    {"extra": "x", "compact": True}])
def test_content_key_matches_reference(kwargs, tmp_path):
    jt, pt = _tensors(DIMS3, nnz=400, seed=10)
    assert (content_key(pt, block=512, row_tile=128, **kwargs)
            == jax_content_key(jt, block=512, row_tile=128, **kwargs))
    assert content_key(pt, block=256, row_tile=128) != content_key(
        pt, block=512, row_tile=128)
    # a file's key hashes its bytes, as the reference's does
    path = tmp_path / "tensor.tnsb"
    write_tnsb(path, pt)
    assert (content_key(path, block=512, row_tile=128, **kwargs)
            == jax_content_key(path, block=512, row_tile=128, **kwargs)
            != content_key(pt, block=512, row_tile=128, **kwargs))


# ---------------------------------------------------------------------------
# the slice as a whole: CP-ALS on the linearized workspace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["linearized", "linearized_cuda"])
@pytest.mark.parametrize("name,scale", [("yelp", 2e-4), ("nell-2", 2e-5)])
def test_fit_on_linearized_matches_reference(name, scale, impl):
    dims, nnz, skew = PAPER_DATASETS[name]
    dims = tuple(max(8, int(d * scale ** (1 / 3))) for d in dims)
    inds, vals = np_coo(dims, max(64, int(nnz * scale)), 0, skew=skew)
    jt, pt = both_tensors(inds, vals, dims)
    jstate, pstate = both_states(np_factors(dims, 6, 1))
    jd = jax_fit(jt, 6, method="cp_als", impl="linearized", niters=20,
                 state=jstate)
    pd = fit(pt, 6, method="cp_als", impl=impl, niters=20, state=pstate)
    factors, lmbda, fit_value = convert.decomp_to_numpy(pd)
    assert np.isfinite(fit_value) and 0.0 < fit_value < 1.0
    np.testing.assert_allclose(fit_value, float(jd.fit), atol=1e-4)
    for a, b in zip(factors, jd.factors):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lmbda, np.asarray(jd.lmbda), rtol=1e-2)


def test_fit_with_calibrated_plan_matches_segment(tmp_path):
    dims, nnz, skew = PAPER_DATASETS["yelp"]
    dims = tuple(max(8, int(d * 1e-4 ** (1 / 3))) for d in dims)
    inds, vals = np_coo(dims, int(nnz * 1e-4), 2, skew=skew)
    _, pt = both_tensors(inds, vals, dims)
    _, pstate = both_states(np_factors(dims, 6, 3))
    plan = plan_decomposition(pt, "auto", rank=6, calibrate=True,
                              autotune=tmp_path,
                              allow=("segment", "linearized"))
    assert set(plan.layouts) <= {"csf", "lin"}
    planned = fit(pt, 6, plan=plan, niters=20, state=pstate)
    seg = fit(pt, 6, impl="segment", niters=20, state=pstate)
    assert float(planned.fit) == pytest.approx(float(seg.fit), abs=1e-5)
