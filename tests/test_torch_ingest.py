"""The port's ingest slice (reader, relabelings, the content-addressed cache,
``Ingested`` and the drivers' handle branch) against the JAX package's.

The first part mirrors ``tests/test_ingest.py`` case for case on the port
alone (the distributed driver and ``plan_report`` are not ported).  The
second passes bytes, maps, cache entries and fits between the packages on
the same numpy inputs: files and cache entries both ways, relabel maps and
content keys bit for bit, and the drivers on a reordered, compacted handle
within the CP parity tolerances (fit 1e-4, factors 1e-2; Tucker subspaces
and values 1e-4).
"""
import dataclasses
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ingest as jax_ingest
from repro.methods import fit as jax_fit
from repro.methods import make_state as jax_make_state
from repro_torch import convert
from repro_torch.core import SparseTensor, random_sparse
from repro_torch.core import coo as coo_mod
from repro_torch.core import csf as csf_mod
from repro_torch.core import linearized as lin_mod
from repro_torch.core.cpals import CPALSState, init_factors
from repro_torch.core.csf import CSF
from repro_torch.ingest import (IngestCache, compact,
                                content_key, convert_tns, degree_sort,
                                identity_relabeling, ingest, random_block,
                                read_any, read_tns, read_tnsb, write_tns,
                                write_tnsb)
from repro_torch.ingest.reader import iter_tnsb_chunks, open_chunk_source
from repro_torch.methods import cp_als, fit
from repro_torch.plan import plan_decomposition
from repro_torch.plan.stats import measured_block_collision, tensor_stats

from test_torch_helpers import (both_states, both_tensors, np_coo,
                                np_factors, planted)

SEED = 3
# the skewed shape the reference's ingest tests use: mode 0 hot, mode 1
# long and uniform
SKEWED_DIMS = (8, 5000, 64)


def skewed_tensor(nnz=2000):
    return random_sparse(SKEWED_DIMS, nnz, SEED, device="cpu")


def small_tensor(nnz=300, dims=(17, 23, 9)):
    return random_sparse(dims, nnz, SEED, device="cpu")


def dense(t):
    return t.to_dense().numpy()


# ---------------------------------------------------------------------------
# reader: .tns text
# ---------------------------------------------------------------------------

def test_read_tns_tolerates_comments_and_blanks(tmp_path):
    p = tmp_path / "x.tns"
    p.write_text(
        "# a FROSTT comment\n"
        "\n"
        "1 1 1 2.5\n"
        "% matrix-market-style comment\n"
        "  \t \n"
        "2 3 1 -1.0\n")
    t = read_tns(p, device="cpu")
    assert t.dims == (2, 3, 1) and t.nnz == 2
    assert np.allclose(t.vals.numpy(), [2.5, -1.0])


def test_read_tns_rejects_ragged_arity(tmp_path):
    p = tmp_path / "x.tns"
    p.write_text("1 1 1 2.5\n1 2 0.5\n")
    with pytest.raises(ValueError, match="x.tns:2.*expected 4 fields"):
        read_tns(p, device="cpu")


def test_read_tns_rejects_non_numeric_and_zero_index(tmp_path):
    p = tmp_path / "x.tns"
    p.write_text("1 1 1 abc\n")
    with pytest.raises(ValueError, match="non-numeric"):
        read_tns(p, device="cpu")
    p.write_text("0 1 1 2.0\n")
    with pytest.raises(ValueError, match="1-based"):
        read_tns(p, device="cpu")


def test_read_tns_explicit_dims_keeps_empty_slices(tmp_path):
    p = tmp_path / "x.tns"
    p.write_text("1 1 1 1.0\n2 2 2 2.0\n")
    assert read_tns(p, device="cpu").dims == (2, 2, 2)
    assert read_tns(p, dims=(5, 2, 7), device="cpu").dims == (5, 2, 7)
    with pytest.raises(ValueError, match="out of range"):
        read_tns(p, dims=(1, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="has 2 modes"):
        read_tns(p, dims=(2, 2), device="cpu")


def test_read_tns_duplicate_policies(tmp_path):
    p = tmp_path / "x.tns"
    p.write_text("1 1 1 1.0\n1 1 1 2.0\n2 1 1 4.0\n")
    t_sum = read_tns(p, device="cpu")
    assert t_sum.nnz == 2
    assert np.isclose(float(t_sum.to_dense()[0, 0, 0]), 3.0)
    assert read_tns(p, duplicates="keep", device="cpu").nnz == 3
    with pytest.raises(ValueError, match="duplicate"):
        read_tns(p, duplicates="error", device="cpu")
    with pytest.raises(ValueError, match="policy"):
        read_tns(p, duplicates="nope", device="cpu")


def test_read_tns_streams_in_chunks(tmp_path):
    t = small_tensor()
    p = tmp_path / "x.tns"
    write_tns(p, t)
    t2 = read_tns(p, dims=t.dims, chunk_lines=7, device="cpu")
    np.testing.assert_allclose(dense(t2), dense(t), rtol=1e-6)


def test_write_read_tns_roundtrip_bit_exact(tmp_path):
    t = small_tensor(nnz=500)
    p = tmp_path / "x.tns"
    write_tns(p, t)
    t2 = read_tns(p, dims=t.dims, duplicates="keep", device="cpu")
    assert t2.nnz == t.nnz
    lin = lambda x: np.ravel_multi_index(tuple(x.inds.numpy().T), t.dims)
    np.testing.assert_array_equal(t.vals.numpy()[np.argsort(lin(t))],
                                  t2.vals.numpy()[np.argsort(lin(t2))])


# ---------------------------------------------------------------------------
# reader: .tnsb binary and chunk sources
# ---------------------------------------------------------------------------

def test_tnsb_roundtrip_and_convert(tmp_path):
    t = small_tensor()
    pb = tmp_path / "x.tnsb"
    write_tnsb(pb, t)
    for mmap in (True, False):
        t2 = read_tnsb(pb, mmap=mmap, device="cpu")
        assert t2.dims == t.dims and t2.nnz == t.nnz
        np.testing.assert_array_equal(t2.inds.numpy(),
                                      t.inds[: t.nnz].numpy())
        np.testing.assert_array_equal(t2.vals.numpy(),
                                      t.vals[: t.nnz].numpy())
        # the tensor owns its memory: no page of the file is shared
        assert t2.vals.numpy().flags.writeable
    pt = tmp_path / "x.tns"
    write_tns(pt, t)
    t3 = convert_tns(pt, tmp_path / "c.tnsb", dims=t.dims, device="cpu")
    t4 = read_tnsb(tmp_path / "c.tnsb", device="cpu")
    np.testing.assert_allclose(dense(t4), dense(t), rtol=1e-6)
    assert t3.dims == t.dims


def test_tnsb_rejects_garbage(tmp_path):
    p = tmp_path / "bad.tnsb"
    p.write_bytes(b"not a tensor at all, but long enough for a header")
    with pytest.raises(ValueError, match="magic"):
        read_tnsb(p, device="cpu")
    p.write_bytes(b"shrt")
    with pytest.raises(ValueError, match="truncated"):
        read_tnsb(p, device="cpu")


@pytest.mark.parametrize("kind", ["memory", "tnsb", "tns", "list"])
def test_chunk_sources_cover_the_tensor(tmp_path, kind):
    """Every source yields chunks at the full dims whose entries, together,
    are the tensor's; each pass re-streams."""
    t = small_tensor(nnz=400)
    if kind == "memory":
        src = open_chunk_source(t, n_chunks=3)
    elif kind == "list":
        src = open_chunk_source(list(open_chunk_source(t, chunk_nnz=150)))
    else:
        p = tmp_path / f"x.{kind}"
        (write_tnsb if kind == "tnsb" else write_tns)(p, t)
        src = open_chunk_source(p, chunk_nnz=150, device="cpu")
    assert src.dims == t.dims and src.nnz == t.nnz
    for _ in range(2):
        chunks = list(src)
        assert all(c.dims == t.dims for c in chunks)
        total = sum(c.to_dense() for c in chunks)
        np.testing.assert_allclose(total.numpy(), dense(t), rtol=1e-6)
    with pytest.raises(TypeError, match="cannot stream"):
        open_chunk_source(42)


def test_tnsb_chunks_are_slices_of_the_file(tmp_path):
    t = small_tensor(nnz=400)
    p = tmp_path / "x.tnsb"
    write_tnsb(p, t)
    chunks = list(iter_tnsb_chunks(p, chunk_nnz=128, device="cpu"))
    sizes = [128] * (t.nnz // 128) + ([t.nnz % 128] if t.nnz % 128 else [])
    assert [c.nnz for c in chunks] == sizes
    np.testing.assert_array_equal(
        torch.cat([c.inds for c in chunks]).numpy(), t.inds[: t.nnz].numpy())


def test_entry_points_default_to_the_card(tmp_path):
    """Without ``device=`` a path lands on the card, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    p = tmp_path / "x.tnsb"
    write_tnsb(p, small_tensor())
    for call in (lambda: read_tnsb(p), lambda: read_any(p),
                 lambda: ingest(p), lambda: identity_relabeling((3, 4)),
                 lambda: list(open_chunk_source(p))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_legacy_tns_io_warns_once(tmp_path, monkeypatch):
    from repro_torch.core import read_tns as legacy_read
    from repro_torch.core import write_tns as legacy_write

    monkeypatch.setattr(coo_mod, "_warned_legacy_io", False)
    t = small_tensor()
    p = tmp_path / "x.tns"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy_write(p, t)
        t2 = legacy_read(p, dims=t.dims, device="cpu")
    assert [w.category for w in caught] == [DeprecationWarning]
    np.testing.assert_allclose(dense(t2), dense(t), rtol=1e-6)


# ---------------------------------------------------------------------------
# relabel: invertibility, composition, factor mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maker", [degree_sort, random_block, compact],
                         ids=["degree_sort", "random_block", "compact"])
def test_relabel_inverse_roundtrip(maker):
    t = skewed_tensor(nnz=800)
    rel = maker(t)
    t2 = rel.apply(t)
    t3 = rel.invert().apply(t2)
    np.testing.assert_array_equal(t3.inds.numpy(), t.inds[: t.nnz].numpy())
    np.testing.assert_array_equal(t3.vals.numpy(), t.vals[: t.nnz].numpy())
    assert t2.nnz == t.nnz
    assert float(t2.norm()) == pytest.approx(float(t.norm()), rel=1e-6)
    assert not rel.is_identity
    assert identity_relabeling(t.dims, "cpu").is_identity


def test_compact_drops_empty_slices():
    t = skewed_tensor()
    t2 = compact(t).apply(t)
    assert t2.dims[1] < t.dims[1]
    counts = np.bincount(t2.inds.numpy()[:, 1], minlength=t2.dims[1])
    assert counts.min() > 0


def test_relabel_compose_matches_sequential():
    t = skewed_tensor(nnz=600)
    r1 = compact(t)
    r2 = degree_sort(r1.apply(t))
    combined = r1.then(r2)
    a = r2.apply(r1.apply(t))
    b = combined.apply(t)
    np.testing.assert_array_equal(a.inds.numpy(), b.inds.numpy())
    np.testing.assert_array_equal(a.vals.numpy(), b.vals.numpy())
    t3 = combined.invert().apply(b)
    np.testing.assert_array_equal(t3.inds.numpy(), t.inds[: t.nnz].numpy())


def test_factor_map_roundtrip():
    t = skewed_tensor(nnz=600)
    rel = degree_sort(t)
    factors = init_factors(t.dims, 5, SEED, device="cpu")
    back = rel.restore_factors(rel.apply_factors(factors))
    for a, b in zip(factors, back):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_restore_factors_zero_fills_dropped_slices():
    t = skewed_tensor()
    rel = compact(t)
    restored = rel.restore_factors(init_factors(rel.dims_new, 4, SEED,
                                                device="cpu"))
    assert restored[1].shape[0] == t.dims[1]
    empty = np.setdiff1d(np.arange(t.dims[1]), rel.old_of_new[1].numpy())
    assert np.all(restored[1].numpy()[empty] == 0.0)


def test_degree_sort_reduces_measured_collision():
    t = skewed_tensor()
    before = tensor_stats(t, block=512, row_tile=128)
    rel = degree_sort(t)
    after = tensor_stats(rel.apply(t), block=512, row_tile=128)
    m = rel.linearized_mode
    assert m is not None
    assert after[m].block_collision_rate < before[m].block_collision_rate
    assert (np.mean([s.block_collision_rate for s in after])
            < np.mean([s.block_collision_rate for s in before]))
    for b, a in zip(before, after):
        assert a.collision_rate == pytest.approx(b.collision_rate, abs=1e-9)


def test_measured_block_collision_bounds():
    assert measured_block_collision(np.array([], dtype=np.int64), 8) == 0.0
    assert measured_block_collision(np.zeros(64, dtype=np.int64), 8) == \
        pytest.approx(1.0 - 8 / 64)
    assert measured_block_collision(np.arange(64), 8) == 0.0


# ---------------------------------------------------------------------------
# cache: content addressing, warm hits skip the builds
# ---------------------------------------------------------------------------

def test_cache_warm_hit_skips_build_and_stats(tmp_path, monkeypatch):
    t = skewed_tensor()
    cold = ingest(t, reorder="degree_sort", cache=tmp_path / "c")
    assert not cold.cache_hit and cold.cache.misses == 1
    assert sorted(cold._csf) == [0, 1, 2] and cold._lin is not None

    calls = []
    for mod, name in ((csf_mod, "build_csf"), (lin_mod, "build_linearized")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            calls.append(a) or _r(*a, **k))
    warm = ingest(t, reorder="degree_sort", cache=tmp_path / "c")
    assert warm.cache_hit and warm.cache.hits == 1
    ws = warm.workspace(warm.plan("segment", rank=4))
    ws_lin = warm.workspace(warm.plan("linearized", rank=4))
    assert calls == []
    assert ws[0] is warm._csf[0] and ws_lin[0] is warm._lin

    np.testing.assert_array_equal(warm.tensor.inds.numpy(),
                                  cold.tensor.inds.numpy())
    assert warm.stats == cold.stats
    assert warm.stats_before == cold.stats_before
    assert warm.relabeling is not None
    for m in range(3):
        np.testing.assert_array_equal(warm._csf[m].row_ids.numpy(),
                                      cold._csf[m].row_ids.numpy())
    for f in ("hi", "lo", "vals", "block_tile"):
        np.testing.assert_array_equal(getattr(warm._lin, f).numpy(),
                                      getattr(cold._lin, f).numpy())


def test_cache_key_separates_options():
    t = skewed_tensor(nnz=200)
    k1 = content_key(t, block=512, row_tile=128)
    k2 = content_key(t, block=256, row_tile=128)
    k3 = content_key(t, block=512, row_tile=128, reorder="degree_sort")
    assert len({k1, k2, k3}) == 3
    t2 = SparseTensor(t.inds, t.vals * 2.0, t.dims, t.nnz, device="cpu")
    assert content_key(t2, block=512, row_tile=128) != k1


def test_cache_key_of_file_matches_warm_path(tmp_path):
    t = small_tensor()
    p = tmp_path / "x.tnsb"
    write_tnsb(p, t)
    cold = ingest(p, cache=tmp_path / "c", device="cpu")
    warm = ingest(p, cache=tmp_path / "c", device="cpu")
    assert not cold.cache_hit and warm.cache_hit
    assert warm.source == str(p)
    np.testing.assert_array_equal(warm.tensor.inds.numpy(),
                                  t.inds[: t.nnz].numpy())


def test_cpals_same_result_cold_and_warm(tmp_path):
    t = skewed_tensor(nnz=600)
    d1 = cp_als(ingest(t, cache=tmp_path / "c"), rank=4, niters=3,
                generator=SEED)
    d2 = cp_als(ingest(t, cache=tmp_path / "c"), rank=4, niters=3,
                generator=SEED)
    assert float(d1.fit) == float(d2.fit)
    for a, b in zip(d1.factors, d2.factors):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cache_key_includes_reader_options(tmp_path):
    t = small_tensor()
    p = tmp_path / "x.tns"
    write_tns(p, t)
    c = tmp_path / "c"
    ingest(p, cache=c, device="cpu")
    b = ingest(p, cache=c, dims=(40, 40, 40), device="cpu")
    assert not b.cache_hit and b.tensor.dims == (40, 40, 40)
    assert not ingest(p, cache=c, duplicates="keep", device="cpu").cache_hit


def test_read_any_tnsb_honors_dims_and_duplicates(tmp_path):
    t = small_tensor()
    p = tmp_path / "x.tnsb"
    write_tnsb(p, t)
    with pytest.raises(ValueError, match="header says dims"):
        read_any(p, dims=(40, 40, 40), device="cpu")
    dup = SparseTensor(np.zeros((3, 3), np.int32), np.ones(3, np.float32),
                       (2, 2, 2), 3, device="cpu")
    pd = tmp_path / "dup.tnsb"
    write_tnsb(pd, dup)
    with pytest.raises(ValueError, match="duplicate"):
        read_any(pd, duplicates="error", device="cpu")
    assert read_any(pd, device="cpu").nnz == 1
    assert read_any(pd, duplicates="keep", device="cpu").nnz == 3


def test_cache_stale_version_self_heals(tmp_path):
    t = small_tensor()
    c = IngestCache(tmp_path / "c")
    cold = ingest(t, cache=c)
    meta_path = c._dir(cold.key) / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["version"] = -1
    meta_path.write_text(json.dumps(meta))
    assert not ingest(t, cache=c).cache_hit
    assert ingest(t, cache=c).cache_hit


# ---------------------------------------------------------------------------
# planner and drivers: ingest-time stats reused, labels restored
# ---------------------------------------------------------------------------

def test_plan_reuses_ingest_stats(monkeypatch):
    t = skewed_tensor()
    ing = ingest(t)
    ref = plan_decomposition(t, "auto", rank=8, backend="cpu")
    import repro_torch.plan.planner as planner_mod
    monkeypatch.setattr(
        planner_mod, "mode_stats",
        lambda *a, **k: pytest.fail("planner re-measured stats"))
    assert ing.plan("auto", rank=8, backend="cpu").impls == ref.impls


def test_plan_rejects_mismatched_stats_geometry():
    t = skewed_tensor()
    stats = tuple(tensor_stats(t, block=256, row_tile=64))
    with pytest.raises(ValueError, match="block=256"):
        plan_decomposition(t, "auto", backend="cpu", stats=stats,
                           block=512, row_tile=128)
    with pytest.raises(ValueError, match="cover"):
        plan_decomposition(t, "auto", backend="cpu", stats=stats[:2])


def test_ingested_workspace_follows_plan():
    t = skewed_tensor()
    ing = ingest(t)
    plan = ing.plan("auto", rank=8, backend="cpu")
    for p, w in zip(plan.modes, ing.workspace(plan)):
        if p.layout == "csf":
            assert isinstance(w, CSF) and w.mode == p.mode
        else:
            assert w is ing.tensor
    with pytest.raises(ValueError, match="tile"):
        ing.workspace(plan_decomposition(t, "segment", block=64,
                                         row_tile=32))


def test_reorder_deltas():
    t = skewed_tensor()
    deltas = ingest(t, reorder="degree_sort").reorder_deltas()
    assert len(deltas) == 3 and set(deltas[0]) == {"collision", "padding",
                                                   "skew"}
    assert ingest(t).reorder_deltas() is None


def test_cpals_reordered_matches_natural_e2e():
    """CP-ALS on a degree_sort-reordered tensor, factors mapped back, equals
    the natural-order run (ALS is equivariant under row relabelings; only
    float32 sums reorder): fit 1e-5, factors 2e-4."""
    t = skewed_tensor(nnz=900)
    rank, niters = 4, 4
    f0 = init_factors(t.dims, rank, SEED, device="cpu")

    def state_of(factors):
        z = torch.tensor(0.0)
        return CPALSState(tuple(factors), torch.ones(rank), z, z,
                          torch.tensor(0, dtype=torch.int32))

    d_nat = cp_als(t, rank, niters=niters, state=state_of(f0))
    ing = ingest(t, reorder="degree_sort")
    d_re = cp_als(ing, rank, niters=niters,
                  state=state_of(ing.relabeling.apply_factors(f0)))
    assert abs(float(d_nat.fit) - float(d_re.fit)) < 1e-5
    for a, b in zip(d_nat.factors, d_re.factors):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_cpals_compacted_restores_original_labels():
    t = skewed_tensor(nnz=600)
    ing = ingest(t, compact=True)
    assert ing.dims[1] < t.dims[1] and ing.original_dims == t.dims
    dec = cp_als(ing, rank=4, niters=3, generator=SEED)
    for m, f in enumerate(dec.factors):
        assert f.shape[0] == t.dims[m]
    empty = np.setdiff1d(np.arange(t.dims[1]), t.inds[: t.nnz, 1].numpy())
    coords = np.zeros((len(empty), 3), dtype=np.int64)
    coords[:, 1] = empty
    np.testing.assert_allclose(
        dec.values_at(torch.from_numpy(coords)).numpy(), 0.0, atol=1e-6)


def test_ingest_rejects_unknown_reorder():
    with pytest.raises(ValueError, match="unknown reorder"):
        ingest(skewed_tensor(nnz=50), reorder="nope")
    with pytest.raises(TypeError, match="SparseTensor or repro_torch.ingest"):
        cp_als([1, 2, 3], rank=2)


def test_cpals_rejects_conflicting_tile_with_ingested():
    ing = ingest(skewed_tensor(nnz=200), tile=(256, 64))
    with pytest.raises(ValueError, match="ingested with block=256"):
        cp_als(ing, rank=3, niters=1, block=512)
    dec = cp_als(ing, rank=3, niters=1, generator=SEED)
    assert np.isfinite(float(dec.fit))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _np_tensor(nnz=1500, seed=7):
    inds, vals = np_coo(SKEWED_DIMS, nnz, seed, skew=1.0)
    return both_tensors(inds, vals, SKEWED_DIMS)


def _assert_same_tensor(jt, pt):
    assert tuple(jt.dims) == pt.dims and int(jt.nnz) == pt.nnz
    np.testing.assert_array_equal(np.asarray(jt.inds[: jt.nnz]),
                                  pt.inds[: pt.nnz].numpy())
    np.testing.assert_array_equal(np.asarray(jt.vals[: jt.nnz]),
                                  pt.vals[: pt.nnz].numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["tns", "tnsb"])
def test_files_pass_between_packages(tmp_path, writer, fmt):
    """A file written by either package is read by the other to the same
    tensor, and both packages write the same bytes."""
    jt, pt = _np_tensor()
    paths = {w: tmp_path / f"{w}.{fmt}" for w in ("jax", "port")}
    jax_w = jax_ingest.write_tns if fmt == "tns" else jax_ingest.write_tnsb
    port_w = write_tns if fmt == "tns" else write_tnsb
    jax_w(paths["jax"], jt)
    port_w(paths["port"], pt)
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    p = paths[writer]
    kw = {"dims": SKEWED_DIMS} if fmt == "tns" else {}
    _assert_same_tensor(jax_ingest.read_any(p, **kw),
                        read_any(p, device="cpu", **kw))


@pytest.mark.parametrize("name", ["degree_sort", "random_block", "compact"])
def test_relabel_maps_match_reference(name):
    jt, pt = _np_tensor()
    jr = getattr(jax_ingest, name)(jt)
    pr = {"degree_sort": degree_sort, "random_block": random_block,
          "compact": compact}[name](pt)
    assert (pr.dims_old, pr.dims_new) == (jr.dims_old, jr.dims_new)
    assert pr.linearized_mode == jr.linearized_mode
    for a, b in zip(jr.new_of_old + jr.old_of_new,
                    pr.new_of_old + pr.old_of_new):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (jr.entry_perm is None) == (pr.entry_perm is None)
    if jr.entry_perm is not None:
        np.testing.assert_array_equal(np.asarray(jr.entry_perm),
                                      pr.entry_perm.numpy())
        np.testing.assert_array_equal(np.asarray(jr.invert().entry_perm),
                                      pr.invert().entry_perm.numpy())
    _assert_same_tensor(jr.apply(jt), pr.apply(pt))
    carried = convert.relabeling_from_numpy(
        [np.asarray(a) for a in jr.new_of_old],
        [np.asarray(a) for a in jr.old_of_new], jr.dims_old, jr.dims_new,
        None if jr.entry_perm is None else np.asarray(jr.entry_perm),
        jr.linearized_mode, "cpu")
    _assert_same_tensor(jr.apply(jt), carried.apply(pt))


def test_content_key_matches_reference_for_files_and_tensors(tmp_path):
    jt, pt = _np_tensor()
    p = tmp_path / "x.tnsb"
    write_tnsb(p, pt)
    for x_jax, x_port in ((jt, pt), (p, p), (str(p), str(p))):
        for kw in ({}, {"reorder": "degree_sort", "compact": True},
                   {"dims": SKEWED_DIMS, "duplicates": "keep"}):
            assert (content_key(x_port, block=512, row_tile=128, **kw)
                    == jax_ingest.content_key(x_jax, block=512,
                                              row_tile=128, **kw))


def _assert_same_entry(j, p):
    """An Ingested handle of each package holds the same state."""
    _assert_same_tensor(j.tensor, p.tensor)
    assert [dataclasses.asdict(s) for s in j.stats] == \
        [dataclasses.asdict(s) for s in p.stats]
    assert [dataclasses.asdict(s) for s in j.stats_before] == \
        [dataclasses.asdict(s) for s in p.stats_before]
    jr, pr = j.relabeling, p.relabeling
    for a, b in zip(jr.new_of_old + jr.old_of_new + (jr.entry_perm,),
                    pr.new_of_old + pr.old_of_new + (pr.entry_perm,)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jr.linearized_mode == pr.linearized_mode
    for m in range(3):
        for f in ("row_ids", "other_ids", "vals", "block_tile"):
            np.testing.assert_array_equal(
                np.asarray(getattr(j._csf[m], f)),
                getattr(p._csf[m], f).numpy())
    for f in ("hi", "lo"):
        np.testing.assert_array_equal(
            np.asarray(getattr(j._lin, f)),
            getattr(p._lin, f).numpy().view(np.uint32))
    for f in ("vals", "block_tile"):
        np.testing.assert_array_equal(np.asarray(getattr(j._lin, f)),
                                      getattr(p._lin, f).numpy())
    assert (p._lin.sort_mode, p._lin.block) == (j._lin.sort_mode,
                                               j._lin.block)


@pytest.mark.parametrize("source", ["memory", "file"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_entries_pass_between_packages(tmp_path, writer, source):
    """An entry stored by either package is a warm hit for the other, with
    the same CSFs, linearized words, stats and relabeling."""
    jt, pt = _np_tensor()
    cache = tmp_path / "c"
    if source == "file":
        path = tmp_path / "x.tnsb"
        write_tnsb(path, pt)
        jx, px = path, path
    else:
        jx, px = jt, pt
    opts = dict(reorder="degree_sort", compact=True, cache=cache)
    if writer == "jax":
        j = jax_ingest.ingest(jx, **opts)
        p = ingest(px, device="cpu", **opts)
        assert not j.cache_hit and p.cache_hit and p.cache.hits == 1
    else:
        p = ingest(px, device="cpu", **opts)
        j = jax_ingest.ingest(jx, **opts)
        assert not p.cache_hit and j.cache_hit and j.cache.hits == 1
    assert j.key == p.key
    _assert_same_entry(j, p)


def _ingested_pair(method):
    """The same compacted, degree-sorted handle on both sides, and the same
    initial state in its relabeled space."""
    dims = (9, 40, 7)
    inds, vals = planted(dims, 3, 5)
    keep = np.random.default_rng(5).random(vals.shape[0]) < 0.5
    # an empty slice in mode 1, so compaction has work
    keep &= inds[:, 1] != 17
    jt, pt = both_tensors(inds[keep], vals[keep], dims)
    jing = jax_ingest.ingest(jt, reorder="degree_sort", compact=True)
    ping = ingest(pt, reorder="degree_sort", compact=True)
    assert ping.dims == tuple(jing.dims) and ping.dims[1] == dims[1] - 1
    if method == "tucker_hooi":
        ranks = (3, 3, 3)
        f0 = [np.linalg.qr(np.random.default_rng(6).standard_normal(
            (d, r)))[0].astype(np.float32) for d, r in zip(ping.dims, ranks)]
        zero = np.float32(0.0)
        jstate = jax_make_state([jnp.asarray(a) for a in f0], {},
                                jnp.asarray(zero), jnp.asarray(zero), 0)
        pstate = convert.tucker_state_from_numpy(f0, zero, 0, "cpu")
        return jing, ping, ranks, jstate, pstate
    jstate, pstate = both_states(np_factors(ping.dims, 4, 6))
    if method == "cp_nn_hals":
        jstate = jax_make_state(jstate.factors, {}, jstate.fit,
                                jstate.fit_prev, 0)
    return jing, ping, 4, jstate, pstate


@pytest.mark.parametrize("method", ["cp_als", "cp_nn_hals", "tucker_hooi"])
def test_ingested_drivers_match_reference(method):
    """Each driver on a reordered, compacted handle matches the reference
    from the same state and returns factors in the original labels."""
    jing, ping, rank, jstate, pstate = _ingested_pair(method)
    jd = jax_fit(jing, rank, method=method, niters=4, state=jstate)
    pd = fit(ping, rank, method=method, niters=4, state=pstate)
    assert abs(float(pd.fit) - float(jd.fit)) < 1e-4
    for a, b, d in zip(pd.factors, jd.factors, ping.original_dims):
        assert a.shape[0] == d
        if method == "tucker_hooi":   # SVD signs: compare subspaces
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_allclose(a @ a.T, b @ b.T, atol=1e-4)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2,
                                       atol=1e-2)
    inds = ping.relabeling.invert().apply(ping.tensor).inds
    np.testing.assert_allclose(pd.values_at(inds).numpy(),
                               np.asarray(jd.values_at(jnp.asarray(
                                   inds.numpy()))), rtol=1e-4, atol=1e-4)
