"""The port's containers, Sort stage, rank-R algebra, MTTKRP registry and
planner against the JAX package's, on the same numpy inputs; and the
port's isolation from JAX."""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.plan import plan_decomposition as jax_plan
from repro_torch import convert
from repro_torch.core import (CSF, available_impls, build_all_modes,
                              build_csf, build_csf_loop_reference, dedupe,
                              gram, init_factors, mttkrp, paper_dataset,
                              random_sparse, from_factors)
from repro_torch.core.coo import PAPER_DATASETS, SparseTensor
from repro_torch.plan import mode_stats, plan_decomposition

from test_torch_helpers import both_tensors, np_coo, np_factors

ROOT = Path(__file__).resolve().parents[1]
# the modules (both packages also export a function named ``gram``)
jgram = importlib.import_module("repro.core.gram")
pgram = importlib.import_module("repro_torch.core.gram")


# ---------------------------------------------------------------------------
# COO container and generators
# ---------------------------------------------------------------------------

def test_dedupe_matches_reference():
    dims = (6, 5, 4)
    inds, vals = np_coo(dims, 300, 1, skew=1.0, unique=False)
    jt, pt = both_tensors(inds, vals, dims)
    jd, pd = jcore.dedupe(jt), dedupe(pt)
    assert pd.nnz == jd.nnz < 300
    np.testing.assert_array_equal(pd.inds.numpy(), np.asarray(jd.inds))
    np.testing.assert_allclose(pd.vals.numpy(), np.asarray(jd.vals),
                               rtol=1e-6)
    assert dedupe(pd) is pd  # already unique: returned as it is


def test_tensor_methods_match_reference():
    dims = (9, 7, 5)
    inds, vals = np_coo(dims, 120, 2)
    jt, pt = both_tensors(inds, vals, dims)
    np.testing.assert_allclose(float(pt.norm()), float(jt.norm()), rtol=1e-6)
    np.testing.assert_allclose(pt.to_dense().numpy(),
                               np.asarray(jt.to_dense()), rtol=1e-6)
    jp, pp = jt.pad_to(64), pt.pad_to(64)
    assert pp.padded_nnz == jp.padded_nnz == 128 and pp.nnz == pt.nnz
    np.testing.assert_array_equal(pp.inds.numpy(), np.asarray(jp.inds))
    np.testing.assert_array_equal(pp.vals.numpy(), np.asarray(jp.vals))
    assert pp.order == 3


def test_generators_on_cpu():
    t = random_sparse((50, 40, 30), 2000, 0, skew=1.5, device="cpu")
    assert t.device.type == "cpu" and t.inds.dtype == torch.int32
    assert t.nnz <= 2000 and t.padded_nnz == t.nnz
    lin = np.ravel_multi_index(tuple(t.inds.numpy().T), t.dims)
    assert np.unique(lin).size == t.nnz
    # skew piles the non-zeros onto the low indices of every mode
    assert (t.inds[:, 0] < 5).float().mean() > 0.3
    again = random_sparse((50, 40, 30), 2000, 0, skew=1.5, device="cpu")
    assert torch.equal(t.inds, again.inds) and torch.equal(t.vals, again.vals)
    f = init_factors((6, 5, 4), 3, 1, device="cpu")
    s = from_factors(f, 50, torch.Generator().manual_seed(2))
    assert s.nnz <= 50 and s.dims == (6, 5, 4)


@pytest.mark.parametrize("name", sorted(PAPER_DATASETS))
def test_paper_dataset_shapes_match_reference(name):
    scale = 2e-5
    t = paper_dataset(name, 0, scale=scale, device="cpu")
    dims, nnz, _ = PAPER_DATASETS[name]
    assert t.dims == tuple(max(8, int(d * scale ** (1 / 3))) for d in dims)
    assert t.nnz <= max(64, int(nnz * scale))
    assert jcore.PAPER_DATASETS[name] == PAPER_DATASETS[name]


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inds, vals = np_coo((4, 4, 4), 10, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseTensor(inds, vals, (4, 4, 4), 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_sparse((4, 4, 4), 10, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_dataset("yelp", 0, scale=1e-5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_factors((4, 4, 4), 2, 0)
    assert SparseTensor(inds, vals, (4, 4, 4), 10,
                        device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the Sort stage: CSF entry for entry
# ---------------------------------------------------------------------------

CSF_CASES = (
    [(dims, nnz, m, 128, 64) for dims, nnz in
     (((50, 40, 30), 600), ((200, 13, 77), 2000), ((64, 64, 64), 4000),
      ((500, 11, 9), 900)) for m in range(3)]
    + [((20, 15, 12, 10), 900, m, 128, 64) for m in range(4)]
    + [((100, 50, 25), 3000, 0, b, rt)
       for b, rt in ((64, 32), (256, 128), (512, 128))]
)


def _assert_same_csf(p: CSF, j) -> None:
    assert (p.mode, p.dims, p.nnz, p.block, p.row_tile) == (
        j.mode, j.dims, j.nnz, j.block, j.row_tile)
    assert p.padded_nnz == j.padded_nnz and p.num_blocks == j.num_blocks
    for name in ("row_ids", "other_ids", "vals", "block_tile"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


@pytest.mark.parametrize("dims,nnz,mode,block,row_tile", CSF_CASES)
def test_build_csf_matches_reference(dims, nnz, mode, block, row_tile):
    inds, vals = np_coo(dims, nnz, seed=nnz)
    jt, pt = both_tensors(inds, vals, dims)
    p = build_csf(pt, mode, block=block, row_tile=row_tile)
    _assert_same_csf(p, jcore.build_csf(jt, mode, block=block,
                                        row_tile=row_tile))
    # the layout contract: every tile has a block, the tile map never
    # decreases, rows stay inside their block's tile, padding is zero
    tiles = p.block_tile.numpy()
    assert set(tiles) == set(range(p.num_row_tiles))
    assert (np.diff(tiles) >= 0).all()
    rows = p.row_ids.numpy().reshape(p.num_blocks, block)
    assert ((rows // row_tile) == tiles[:, None]).all()
    assert (np.diff(p.row_ids.numpy()) >= 0).all()
    assert np.count_nonzero(p.vals.numpy()) == p.nnz


def test_loop_reference_and_all_modes_match_reference():
    dims = (60, 45, 30)
    inds, vals = np_coo(dims, 700, 5)
    jt, pt = both_tensors(inds, vals, dims)
    _assert_same_csf(build_csf_loop_reference(pt, 1),
                     jcore.build_csf_loop_reference(jt, 1))
    for p, j in zip(build_all_modes(pt, block=64, row_tile=32),
                    jcore.build_all_modes(jt, block=64, row_tile=32)):
        _assert_same_csf(p, j)
    with pytest.raises(ValueError):
        build_csf(pt, 3)


def test_csf_from_numpy_round_trip():
    dims = (30, 20, 10)
    inds, vals = np_coo(dims, 200, 6)
    jt, _ = both_tensors(inds, vals, dims)
    j = jcore.build_csf(jt, 2, block=64, row_tile=32)
    p = convert.csf_from_numpy(j.mode, j.row_ids, j.other_ids, j.vals,
                               j.block_tile, j.dims, j.nnz, j.block,
                               j.row_tile, "cpu")
    _assert_same_csf(p, j)
    assert p.other_modes == j.other_modes and p.num_rows == j.num_rows


# ---------------------------------------------------------------------------
# dense rank-R algebra
# ---------------------------------------------------------------------------

def _gram_inputs():
    rng = np.random.default_rng(11)
    a = [rng.uniform(0, 1, (d, 6)).astype(np.float32) for d in (40, 30, 20)]
    m = rng.uniform(0, 1, (40, 6)).astype(np.float32)
    lam = rng.uniform(0.5, 2, 6).astype(np.float32)
    signed = rng.standard_normal((40, 6)).astype(np.float32)
    return a, m, lam, signed


GRAM_ROUTINES = {
    "gram": lambda g, a, m, lam, s: g.gram(a[0]),
    "hadamard_grams": lambda g, a, m, lam, s: g.hadamard_grams(
        [g.gram(x) for x in a], 1),
    "solve_cholesky": lambda g, a, m, lam, s: g.solve_cholesky(
        m, g.hadamard_grams([g.gram(x) for x in a], 0)),
    "solve_gram": lambda g, a, m, lam, s: g.solve_gram(
        m, g.hadamard_grams([g.gram(x) for x in a], 0)),
    "column_norms_max": lambda g, a, m, lam, s: g.normalize(s, kind="max"),
    "column_norms_2": lambda g, a, m, lam, s: g.normalize(s, kind="2"),
    "kruskal_norm_sq": lambda g, a, m, lam, s: g.kruskal_norm_sq(
        lam, [g.gram(x) for x in a]),
    "kruskal_inner": lambda g, a, m, lam, s: g.kruskal_inner(m, a[0], lam),
    "kruskal_fit": lambda g, a, m, lam, s: g.kruskal_fit(
        (m * m).sum() * 4, lam, [g.gram(x) for x in a], m, a[0]),
}


@pytest.mark.parametrize("routine", sorted(GRAM_ROUTINES))
def test_gram_routines_match_reference(routine):
    a, m, lam, s = _gram_inputs()
    fn = GRAM_ROUTINES[routine]
    want = fn(jgram, [jnp.asarray(x) for x in a], jnp.asarray(m),
              jnp.asarray(lam), jnp.asarray(s))
    got = fn(pgram, [torch.from_numpy(x) for x in a],
             torch.from_numpy(m), torch.from_numpy(lam), torch.from_numpy(s))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_gram_impls_and_ridge():
    a = torch.rand((50, 5), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(gram(a, impl="cuda"), gram(a), rtol=1e-6,
                               atol=1e-6)  # the plain SYRK on a CPU tensor
    with pytest.raises(ValueError):
        gram(a, impl="jnp")
    assert pgram.CHOLESKY_RIDGE == jgram.CHOLESKY_RIDGE


# ---------------------------------------------------------------------------
# the MTTKRP registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,layout", [
    ("gather_scatter", "coo"), ("gather_scatter", "csf"),
    ("segment", "csf"), ("rowloop", "coo"), ("dense", "coo")])
@pytest.mark.parametrize("dims,skew", [((30, 20, 10), 1.5),
                                       ((12, 10, 8, 6), 0.0)])
def test_mttkrp_impls_match_reference(impl, layout, dims, skew):
    nnz = 150 if impl == "rowloop" else 600
    inds, vals = np_coo(dims, nnz, 8, skew=skew)
    jt, pt = both_tensors(inds, vals, dims)
    factors = np_factors(dims, 5, 9)
    jf = tuple(jnp.asarray(a) for a in factors)
    pf = tuple(torch.from_numpy(a) for a in factors)
    mode = 1
    if layout == "csf":
        jx = jcore.build_csf(jt, mode, block=64, row_tile=8)
        px = build_csf(pt, mode, block=64, row_tile=8)
    else:
        jx, px = jt, pt
    got = mttkrp(px, pf, mode, impl=impl)
    want = jcore.mttkrp(jx, jf, mode, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_registry_capabilities():
    assert "cuda" in available_impls(backend="cuda")
    assert "cuda" not in available_impls(backend="cpu")
    assert "rowloop" not in available_impls()
    assert "dense" in available_impls(include_oracle=True)
    with pytest.raises(ValueError, match="planner policy"):
        mttkrp(None, (), 0, impl="auto")
    with pytest.raises(ValueError, match="unknown impl"):
        mttkrp(None, (), 0, impl="pallas")


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,nnz,skew", [((8, 5000, 64), 2000, 0.0),
                                            ((40, 30, 20), 3000, 0.0),
                                            ((300, 200, 100), 6000, 1.5)])
def test_auto_plan_matches_reference(dims, nnz, skew):
    inds, vals = np_coo(dims, nnz, 10, skew=skew)
    jt, pt = both_tensors(inds, vals, dims)
    jp = jax_plan(jt, "auto", rank=8, backend="cpu")
    pp = plan_decomposition(pt, "auto", rank=8)
    assert pp.backend == "cpu"
    assert pp.impls == jp.impls, (pp.summary(), jp.summary())
    assert pp.layouts == jp.layouts
    for p, j in zip(pp.modes, jp.modes):
        assert dataclasses.astuple(p.stats) == dataclasses.astuple(j.stats)
        for name, cost in p.costs.items():
            assert cost == pytest.approx(j.costs[name], rel=1e-12)


def test_plan_policies_and_refusals():
    inds, vals = np_coo((8, 500, 64), 800, 12)
    _, pt = both_tensors(inds, vals, (8, 500, 64))
    plan = plan_decomposition(pt, "segment", rank=4)
    assert plan.impls == ("segment",) * 3 and plan.layouts == ("csf",) * 3
    lean = plan_decomposition(pt, "gather_scatter", with_stats=False)
    assert lean.layouts == ("coo",) * 3
    assert all(p.stats is None for p in lean.modes)
    assert plan_decomposition(pt, "auto", backend="cuda").impls == (
        "cuda",) * 3
    assert mode_stats(pt, 0, block=512, row_tile=128).regime == "contention"
    calibrated = plan_decomposition(pt, "auto", calibrate=True)
    assert all(p.source == "measured-fresh" for p in calibrated.modes)
    assert set(calibrated.modes[0].costs) == set(available_impls(
        backend="cpu"))
    # without calibrate= the store is not consulted: predicted costs
    stored = plan_decomposition(pt, "segment", autotune="store")
    assert all(p.source == "predicted" for p in stored.modes)
    assert plan_decomposition(pt, "linearized").layouts == ("lin",) * 3
    with pytest.raises(ValueError, match="unknown impl"):
        plan_decomposition(pt, "pallas")


# ---------------------------------------------------------------------------
# isolation: the port never imports JAX or the JAX package
# ---------------------------------------------------------------------------

PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path.name} imports {name}")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
