"""The port's TTMc (the Tucker kernel), its plain kernel versions and its
planner against the JAX package's, on the same numpy inputs.

Ranks are unequal on purpose, so a wrong Kronecker column order cannot
pass.  The JAX side runs as its own tests run it on the CPU: ``pallas`` and
``linearized_pallas`` in interpret mode.  Every TTMc impl is held at 1e-4
(float32 sums in another order), the plain kernel versions at 1e-5 (the
same gathers and products, summed by one scatter) and at 5e-2 in bfloat16.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csf import build_csf as jax_build_csf
from repro.core.linearized import build_linearized as jax_build_linearized
from repro.core.ttmc import TTMC_REGISTRY as JAX_TTMC_REGISTRY
from repro.core.ttmc import kron_chain as jax_kron_chain
from repro.core.ttmc import ttmc as jax_ttmc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.plan import plan_decomposition as jax_plan
from repro.plan import planner as jax_planner
from repro_torch import convert
from repro_torch.core import (CSF, TTMC_IMPLS, TTMC_REGISTRY, Linearized,
                              available_ttmc_impls, build_workspace,
                              kron_chain, ttmc)
from repro_torch.kernels import ref
from repro_torch.plan import plan_decomposition, registry_fingerprint
from repro_torch.plan import planner as planner_mod

from test_torch_helpers import both_tensors, np_coo

DIMS3, RANKS3 = (23, 17, 31), (2, 3, 4)
DIMS4, RANKS4 = (13, 11, 9, 7), (2, 3, 2, 3)
CASES = {3: (DIMS3, RANKS3), 4: (DIMS4, RANKS4)}
PORT_TO_REF = {"gather_scatter": "gather_scatter", "segment": "segment",
               "cuda": "pallas", "linearized": "linearized",
               "linearized_cuda": "linearized_pallas"}


def _factors(dims, ranks, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, r)).astype(np.float32)
            for d, r in zip(dims, ranks)]


def _csf_by_value(jc) -> CSF:
    return convert.csf_from_numpy(jc.mode, jc.row_ids, jc.other_ids, jc.vals,
                                  jc.block_tile, jc.dims, jc.nnz, jc.block,
                                  jc.row_tile, "cpu")


def _lin_by_value(jl) -> Linearized:
    return convert.linearized_from_numpy(
        jl.hi, jl.lo, jl.vals, jl.block_tile, jl.dims, jl.nnz, jl.block,
        jl.row_tile, jl.sort_mode, "cpu")


@pytest.fixture(scope="module", params=[3, 4])
def workspaces(request):
    """One tensor and its workspaces on both sides, the factors, and the
    reference's TTMc of every mode by its dense, segment, pallas and
    linearized_pallas impls."""
    dims, ranks = CASES[request.param]
    inds, vals = np_coo(dims, 500, request.param, skew=0.5)
    jt, pt = both_tensors(inds, vals, dims)
    fs = _factors(dims, ranks, 1)
    jf = tuple(jnp.asarray(a) for a in fs)
    jlin = jax_build_linearized(jt, block=64, row_tile=16)
    modes = []
    for mode in range(len(dims)):
        jcsf = jax_build_csf(jt, mode, block=64, row_tile=16)
        want = {name: np.asarray(jax_ttmc(ws, jf, mode, impl=name))
                for name, ws in (("dense", jt), ("segment", jcsf),
                                 ("pallas", jcsf),
                                 ("linearized_pallas", jlin))}
        modes.append((_csf_by_value(jcsf), jcsf, want))
    return dict(dims=dims, ranks=ranks, pt=pt, jt=jt, fs=fs, jf=jf,
                pf=tuple(torch.from_numpy(a) for a in fs),
                plin=_lin_by_value(jlin), jlin=jlin, modes=modes)


# ---------------------------------------------------------------------------
# the column order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [(2, 3), (2, 3, 4), (1, 5, 2), (3, 1),
                                   (2, 3, 2, 3)])
def test_kron_chain_bit_for_bit(ranks):
    rng = np.random.default_rng(sum(ranks))
    rows = [rng.standard_normal((9, r)).astype(np.float32) for r in ranks]
    got = kron_chain([torch.from_numpy(a) for a in rows]).numpy()
    want = np.asarray(jax_kron_chain([jnp.asarray(a) for a in rows]))
    assert got.shape == (9, int(np.prod(ranks)))
    np.testing.assert_array_equal(got, want)
    # column r_0 * R_1 * ... + ... + r_last: ascending inputs, row-major
    idx = tuple(r - 1 for r in ranks)
    col = int(np.ravel_multi_index(idx, ranks))
    np.testing.assert_array_equal(
        got[:, col], np.prod([a[:, i] for a, i in zip(rows, idx)], axis=0))


# ---------------------------------------------------------------------------
# every impl, every mode, orders 3 and 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", list(PORT_TO_REF))
def test_ttmc_impls_match_reference_every_mode(workspaces, impl):
    w = workspaces
    for mode, (pcsf, _, want) in enumerate(w["modes"]):
        ws = w["plin"] if impl.startswith("linearized") else pcsf
        got = ttmc(ws, w["pf"], mode, impl=impl)
        width = int(np.prod([r for m, r in enumerate(w["ranks"])
                             if m != mode]))
        assert got.shape == (w["dims"][mode], width)
        assert got.dtype == torch.float32
        for ref_impl, ref_out in want.items():
            np.testing.assert_allclose(
                got.numpy(), ref_out, rtol=1e-4, atol=1e-4,
                err_msg=f"{impl} vs {ref_impl}, mode {mode}")


def test_gather_scatter_off_coo_matches_reference(workspaces):
    w = workspaces
    for mode, (_, _, want) in enumerate(w["modes"]):
        got = ttmc(w["pt"], w["pf"], mode, impl="gather_scatter")
        np.testing.assert_allclose(got.numpy(), want["dense"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(
            ttmc(w["pt"], w["pf"], mode, impl="dense").numpy(),
            want["dense"], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the plain kernel versions
# ---------------------------------------------------------------------------

def test_ttmc_ref_matches_reference_ref(workspaces):
    w = workspaces
    for mode, (pcsf, jcsf, _) in enumerate(w["modes"]):
        got = ref.ttmc_ref(pcsf, w["pf"])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jref.ttmc_ref(jcsf, w["jf"])),
                                   rtol=1e-5, atol=1e-5)
        # in chunks of a few entries, the same sums in the same order
        torch.testing.assert_close(ref.ttmc_ref(pcsf, w["pf"], chunk=37),
                                   got, rtol=1e-6, atol=1e-6)


def test_ttmc_lin_ref_matches_reference_every_mode(workspaces):
    w = workspaces
    for mode, (_, jcsf, _) in enumerate(w["modes"]):
        got = ref.ttmc_lin_ref(w["plin"], w["pf"], mode)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jref.ttmc_ref(jcsf, w["jf"])),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            ref.ttmc_lin_ref(w["plin"], w["pf"], mode, chunk=64), got,
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl,layout", [
    ("gather_scatter", "coo"), ("gather_scatter", "csf"), ("segment", "csf"),
    ("linearized", "sort"), ("linearized", "other")])
def test_plain_ttmc_impls_run_in_bounded_chunks(workspaces, monkeypatch,
                                                impl, layout):
    """The plain impls form the Kronecker rows of a bounded chunk of stored
    entries at a time (``TTMC_CHUNK_BYTES``); the chunked sums equal the
    one-pass ones and the reference's."""
    w = workspaces
    sort_mode = w["plin"].sort_mode
    mode = (sort_mode + 1) % len(w["dims"]) if layout == "other" else sort_mode
    ws = {"coo": w["pt"], "csf": w["modes"][mode][0],
          "sort": w["plin"], "other": w["plin"]}[layout]
    one_pass = ttmc(ws, w["pf"], mode, impl=impl)
    width = math.prod(r for m, r in enumerate(w["ranks"]) if m != mode)
    core_ttmc = importlib.import_module("repro_torch.core.ttmc")
    monkeypatch.setattr(core_ttmc, "TTMC_CHUNK_BYTES", 4 * width * 7)
    seen = []
    kron = core_ttmc.kron_chain

    def counting_kron(rows):
        seen.append(rows[0].shape[0])
        return kron(rows)

    monkeypatch.setattr(core_ttmc, "kron_chain", counting_kron)
    got = ttmc(ws, w["pf"], mode, impl=impl)
    assert max(seen) == 7 and sum(seen) == ws.vals.shape[0]
    assert len(seen) == math.ceil(ws.vals.shape[0] / 7)
    torch.testing.assert_close(got, one_pass, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), w["modes"][mode][2]["dense"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sort_mode", [0, 1, 2])
def test_plain_kernels_match_reference_ops_in_bfloat16(sort_mode):
    inds, vals = np_coo(DIMS3, 700, 4, skew=1.0)
    jt, _ = both_tensors(inds, vals, DIMS3)
    jf = tuple(jnp.asarray(a).astype(jnp.bfloat16)
               for a in _factors(DIMS3, RANKS3, 5))
    pf = tuple(torch.from_numpy(np.array(a.astype(jnp.float32)))
               .to(torch.bfloat16) for a in jf)
    jcsf = jax_build_csf(jt, sort_mode, block=64, row_tile=16)
    jlin = jax_build_linearized(jt, block=64, row_tile=16,
                                sort_mode=sort_mode)
    want = np.asarray(jops.ttmc(jcsf, jf).astype(jnp.float32))
    np.testing.assert_allclose(
        ref.ttmc_ref(_csf_by_value(jcsf), pf).numpy(), want, rtol=5e-2,
        atol=5e-2)
    want_lin = np.asarray(jops.ttmc_lin(jlin, jf, sort_mode).astype(
        jnp.float32))
    np.testing.assert_allclose(
        ref.ttmc_lin_ref(_lin_by_value(jlin), pf, sort_mode).numpy(),
        want_lin, rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# registry, dispatcher and planner
# ---------------------------------------------------------------------------

def test_registry_mirrors_reference():
    renamed = {v: k for k, v in PORT_TO_REF.items()}
    assert set(TTMC_REGISTRY) == {renamed.get(n, n)
                                  for n in JAX_TTMC_REGISTRY}
    assert TTMC_IMPLS == tuple(TTMC_REGISTRY)
    for jname, jspec in JAX_TTMC_REGISTRY.items():
        spec = TTMC_REGISTRY[renamed.get(jname, jname)]
        for field in ("layout", "needs_sorted", "supports_order_gt3",
                      "benchmark_only", "oracle"):
            assert getattr(spec, field) == getattr(jspec, field), field
        assert spec.backend == ("cuda" if jspec.backend == "tpu"
                                else jspec.backend)
        assert (spec.cost_model is None) == (jspec.cost_model is None)
    assert available_ttmc_impls(backend="cpu") == (
        "gather_scatter", "segment", "linearized")
    assert set(available_ttmc_impls(backend="cuda")) == (
        set(TTMC_REGISTRY) - {"dense"})


def test_dispatcher_errors():
    inds, vals = np_coo(DIMS3, 200, 0)
    _, pt = both_tensors(inds, vals, DIMS3)
    f = tuple(torch.from_numpy(a) for a in _factors(DIMS3, RANKS3, 0))
    with pytest.raises(ValueError, match="planner policy"):
        ttmc(pt, f, 0, impl="auto")
    with pytest.raises(ValueError, match="unknown impl"):
        ttmc(pt, f, 0, impl="pallas")
    for impl in ("linearized", "linearized_cuda"):
        with pytest.raises(TypeError, match="Linearized workspace"):
            ttmc(pt, f, 0, impl=impl)
    for impl in ("segment", "cuda"):
        with pytest.raises(TypeError, match="CSF workspace"):
            ttmc(pt, f, 0, impl=impl)
    csf = build_workspace(pt, plan_decomposition(pt, "segment", rank=4))[0]
    for impl in ("segment", "cuda", "gather_scatter"):
        with pytest.raises(ValueError, match="built for mode 0"):
            ttmc(csf, f, 1, impl=impl)


def _widths(ranks):
    return tuple(int(np.prod([r for m, r in enumerate(ranks) if m != n]))
                 for n in range(len(ranks)))


@pytest.mark.parametrize("dims,ranks,nnz,skew",
                         [(DIMS3, RANKS3, 600, 0.0),
                          ((300, 200, 100), (8, 4, 6), 6000, 1.5),
                          (DIMS4, RANKS4, 900, 1.0)])
def test_predicted_ttmc_plans_match_reference(dims, ranks, nnz, skew):
    inds, vals = np_coo(dims, nnz, 6, skew=skew)
    jt, pt = both_tensors(inds, vals, dims)
    widths = _widths(ranks)
    jp = jax_plan(jt, "auto", rank=widths, kernel="ttmc", backend="cpu")
    pp = plan_decomposition(pt, "auto", rank=widths, kernel="ttmc",
                            backend="cpu")
    assert pp.impls == jp.impls and pp.layouts == jp.layouts
    assert pp.rank == widths
    for p, j in zip(pp.modes, jp.modes):
        assert p.kernel == j.kernel == "ttmc"
        assert tuple(p.costs) == tuple(j.costs)
        for name, cost in p.costs.items():
            assert cost == pytest.approx(j.costs[name], rel=1e-9)


def test_fixed_ttmc_plans_and_workspaces():
    inds, vals = np_coo(DIMS3, 400, 7)
    _, pt = both_tensors(inds, vals, DIMS3)
    widths = _widths(RANKS3)
    plan = plan_decomposition(pt, "linearized", rank=widths, kernel="ttmc")
    assert plan.layouts == ("lin",) * 3
    assert all(p.kernel == "ttmc" for p in plan.modes)
    ws = build_workspace(pt, plan)
    assert all(w is ws[0] for w in ws)
    costs = plan_decomposition(pt, "segment", rank=widths, kernel="ttmc")
    # a per-mode width scores each mode at its own Kronecker width
    assert [p.costs["segment"] for p in costs.modes] == [
        p.costs["segment"] for p in plan_decomposition(
            pt, "segment", rank=widths, kernel="mttkrp").modes]
    with pytest.raises(ValueError, match="unknown impl"):
        plan_decomposition(pt, "rowloop", rank=widths, kernel="ttmc")
    with pytest.raises(ValueError, match="unknown kernel"):
        plan_decomposition(pt, "segment", rank=4, kernel="mttkrp2")


def test_calibrating_ttmc_without_factor_ranks_raises_reference_text():
    inds, vals = np_coo(DIMS3, 300, 8)
    jt, pt = both_tensors(inds, vals, DIMS3)
    with pytest.raises(ValueError) as want:
        jax_planner._calibrate_mode(jt, 0, ("segment",), rank=12, block=64,
                                    row_tile=16, kernel="ttmc")
    with pytest.raises(ValueError) as got:
        plan_decomposition(pt, "auto", rank=_widths(RANKS3), kernel="ttmc",
                           calibrate=True)
    assert str(got.value) == str(want.value)


def test_ttmc_registry_fingerprint_differs_from_mttkrp():
    fp = registry_fingerprint("ttmc")
    assert len(fp) == 16 and fp == registry_fingerprint("ttmc")
    assert fp != registry_fingerprint("mttkrp")
    assert planner_mod._kernel_registry("ttmc") is TTMC_REGISTRY
