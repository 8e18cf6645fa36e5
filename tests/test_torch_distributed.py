"""The port's distributed executor, ``repro_torch.core.distributed`` over
``repro_torch.dist``, against the JAX package's single-device ``cp_als``.

The reference's own distributed tests are red (ROADMAP.md §3), so the
oracle is its single-device ``cp_als`` from the same initial factors, and
the port's own ``cp_als`` beside it.  Tolerances: fit within 1e-4 and every
factor within 1e-2 (max abs; the columns are unit-norm): the grid sums the
same products in another order, and the ALS solves amplify that.

The grids run as ``torch.multiprocessing`` spawns on gloo over a
``FileStore`` in ``tmp_path`` (no TCP port, so parallel test workers cannot
collide): one 2x2 grid (4 ranks) and one 2-rank spawn (a 2x1 grid, a
(pod=2, data=1, model=1) grid and an ``Ingested`` input), each joined with
a timeout.  Every rank writes what it computed; the checks run here.  The
reference is imported inside the tests, so the spawned ranks, which import
this module, load neither JAX nor ``repro``.
"""
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from repro_torch.api import (ConfigError, ExecConfig, MethodConfig,
                             PlanConfig, RunConfig, Session, run)
from repro_torch.core.distributed import (DIST_IMPLS, _local_mttkrp,
                                          dist_cp_als, partition_tensor)
from repro_torch.dist import (Mesh, StragglerMonitor, axis_product,
                              batch_axes, cpals_axes)
from repro_torch.dist.straggler import record_step_times

DIMS = (37, 23, 19)
NNZ = 1500
RANK = 5
NITERS = 6
FIT_TOL = 1e-4
FACTOR_TOL = 1e-2
SPAWN_TIMEOUT_S = 240


def case():
    """The tensor and the initial factors, made with numpy from seeds."""
    from test_torch_helpers import np_coo, np_factors

    inds, vals = np_coo(DIMS, NNZ, 5)
    return inds, vals, np_factors(DIMS, RANK, 0)


def port_tensor(inds, vals):
    from repro_torch import convert

    return convert.sparse_tensor_from_numpy(inds, vals, DIMS,
                                            int(vals.shape[0]), "cpu")


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank, world, store, out_dir, body, args):
    """One rank: a gloo group over the file store, ``body``'s results (or
    its traceback) pickled to ``out_dir``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        result = body(rank, *args)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported by the parent
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _spawn(tmp_path, world, body, *args):
    """Run ``body(rank, *args)`` on ``world`` spawned ranks; their results
    in rank order.  Fails on a timeout or a rank's error."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = tmp_path / f"ranks{world}"
    out.mkdir()
    procs = [ctx.Process(target=_rank_entry, args=(
        r, world, str(tmp_path / f"store{world}"), str(out), body, args))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after " \
                      f"{SPAWN_TIMEOUT_S} s"
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    errors = [res["error"] for res in results if "error" in res]
    assert not errors, errors[0]
    return results


def _np(x):
    return [a.numpy() for a in x] if isinstance(x, (tuple, list)) \
        else x.numpy()


def _fit_out(out):
    factors, lam, fit = out
    return {"factors": _np(factors), "lmbda": lam.numpy(),
            "fit": float(fit)}


def _grid_2x2(rank, inds, vals, init):
    """The 2x2 grid's checks on one rank."""
    import torch.distributed as dist

    from repro_torch.dist import (gather_rows, make_mesh, pgram,
                                  scatter_rows, shard_map)
    from repro_torch.dist.collectives import psum

    t = port_tensor(inds, vals)
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {"coords": mesh.coords(), "row": mesh.axis_index("data"),
           "col": mesh.axis_index("model"),
           "all": mesh.axis_index(("data", "model")),
           "group_sizes": {k: dist.get_world_size(g)
                           for k, g in mesh.groups.items()}}
    # the collectives on known inputs
    x = torch.arange(16, dtype=torch.float32).reshape(8, 2) * (rank + 1)
    res["psum_row"] = psum(x.clone(), mesh, "data").numpy()
    res["scatter"] = scatter_rows(x, mesh, (("data",), "model")).numpy()
    res["gather"] = gather_rows(torch.full((2, 2), float(rank)), mesh,
                                (("data",), "model")).numpy()
    res["pgram"] = pgram(torch.ones(3, 2) * rank, mesh,
                         ("data", "model")).numpy()
    g = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    res["shard_map"] = shard_map(
        lambda blk: blk * 1.0, mesh=mesh, in_specs=((("data",), "model"),),
        out_specs=(("data",), "model"))(g).numpy()
    # the fits
    for name, kw in (("baseline", {}), ("shard_c", {"shard_c": True}),
                     ("mode_order_auto", {"mode_order": "auto"}),
                     ("shard_c_auto", {"shard_c": True,
                                       "mode_order": "auto"}),
                     ("gather_scatter", {"impl": "gather_scatter"}),
                     ("segment", {"impl": "segment"})):
        res[name] = _fit_out(dist_cp_als(t, RANK, mesh, niters=NITERS,
                                         init=init, **kw))
    # the dist executor on the process group that exists
    cfg = RunConfig(method=MethodConfig(rank=RANK, niters=NITERS),
                    exec=ExecConfig(executor="dist",
                                    mesh_shape={"data": 2, "model": 2}))
    with Session(cfg, tensor=t, device="cpu") as sess:
        dec = sess.fit()
        plan = sess.plan()
        res["session"] = {"factors": _np(dec.factors),
                          "lmbda": dec.lmbda.numpy(),
                          "fit": float(dec.fit), "impls": plan.impls}
        res["direct"] = _fit_out(dist_cp_als(
            t, RANK, sess.mesh(), niters=NITERS, plan=plan,
            generator=sess.method_generator()))
    res["group_kept"] = dist.is_initialized()
    # every rank's step time reaches every monitor
    mon = StragglerMonitor(window=4, threshold=1.5, patience=1, warmup=1)
    for _ in range(2):
        record_step_times(mon, 0.1 * (rank + 1))
    res["means"] = mon.means()
    return res


def _grid_2_ranks(rank, inds, vals, init):
    """A (data=2, model=1) grid, a (pod=2, data=1, model=1) grid, and an
    ingested, reordered input on the first."""
    from repro_torch.dist import make_mesh
    from repro_torch.ingest import ingest

    t = port_tensor(inds, vals)
    res = {}
    mesh = make_mesh((2, 1), ("data", "model"))
    res["2x1"] = _fit_out(dist_cp_als(t, RANK, mesh, niters=NITERS,
                                      init=init))
    res["2x1_shard_c"] = _fit_out(dist_cp_als(
        t, RANK, mesh, niters=NITERS, init=init, shard_c=True))
    pod = make_mesh((2, 1, 1), ("pod", "data", "model"))
    res["pod_rows"] = cpals_axes(pod).row
    res["pod"] = _fit_out(dist_cp_als(t, RANK, pod, niters=NITERS,
                                      init=init))
    ing = ingest(t, reorder="degree_sort", device="cpu")
    init_relabeled = ing.relabeling.apply_factors(
        tuple(torch.from_numpy(a) for a in init))
    res["ingested"] = _fit_out(dist_cp_als(ing, RANK, mesh, niters=NITERS,
                                           init=init_relabeled))
    return res


# ---------------------------------------------------------------------------
# the oracles: single-device cp_als in both packages, the same init
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle():
    from repro.core.cpals import cp_als as jax_cp_als
    from repro_torch.methods import fit
    from test_torch_helpers import both_states, both_tensors

    inds, vals, init = case()
    jt, pt = both_tensors(inds, vals, DIMS)
    jstate, pstate = both_states(init)
    ref = jax_cp_als(jt, rank=RANK, niters=NITERS, state=jstate)
    port = fit(pt, RANK, niters=NITERS, state=pstate, impl="segment")
    return {"reference": {"fit": float(ref.fit), "lmbda": np.asarray(
                ref.lmbda), "factors": [np.asarray(a) for a in ref.factors]},
            "port": {"fit": float(port.fit), "lmbda": port.lmbda.numpy(),
                     "factors": [a.numpy() for a in port.factors]}}


@pytest.fixture(scope="module")
def grid_2x2(tmp_path_factory):
    inds, vals, init = case()
    return _spawn(tmp_path_factory.mktemp("grid2x2"), 4, _grid_2x2, inds,
                  vals, init)


@pytest.fixture(scope="module")
def grid_2_ranks(tmp_path_factory):
    inds, vals, init = case()
    return _spawn(tmp_path_factory.mktemp("grid2"), 2, _grid_2_ranks, inds,
                  vals, init)


def assert_matches(got, want, what):
    assert abs(got["fit"] - want["fit"]) < FIT_TOL, (what, got["fit"],
                                                     want["fit"])
    for m, (a, b) in enumerate(zip(got["factors"], want["factors"])):
        assert a.shape == b.shape, (what, m)
        err = float(np.max(np.abs(a - b)))
        assert err < FACTOR_TOL, (what, m, err)


def assert_same_on_every_rank(results, name):
    first = results[0][name]
    for res in results[1:]:
        assert res[name]["fit"] == first["fit"]
        for a, b in zip(res[name]["factors"], first["factors"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the 2x2 grid (4 ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["baseline", "shard_c", "mode_order_auto",
                                  "shard_c_auto", "gather_scatter",
                                  "segment"])
@pytest.mark.parametrize("against", ["reference", "port"])
def test_dist_2x2_matches_single_device_cp_als(grid_2x2, oracle, name,
                                               against):
    assert_same_on_every_rank(grid_2x2, name)
    assert_matches(grid_2x2[0][name], oracle[against],
                   f"2x2 {name} vs {against}")


def test_dist_2x2_shard_c_and_mode_order_match_the_baseline(grid_2x2):
    base = grid_2x2[0]["baseline"]
    for name in ("shard_c", "mode_order_auto", "shard_c_auto"):
        assert_matches(grid_2x2[0][name], base, name)


def test_dist_executor_on_a_2x2_grid_is_dist_cp_als(grid_2x2):
    """Session.fit(executor="dist") on the existing group: the plan is
    restricted to DIST_IMPLS, the result is the direct driver's bit for
    bit, and the Session leaves the group it did not start."""
    for res in grid_2x2:
        sess, direct = res["session"], res["direct"]
        assert set(sess["impls"]) <= set(DIST_IMPLS)
        assert sess["fit"] == direct["fit"]
        for a, b in zip(sess["factors"], direct["factors"]):
            np.testing.assert_array_equal(a, b)
        assert res["group_kept"]


def test_mesh_coordinates_groups_and_collectives_on_2x2(grid_2x2):
    for rank, res in enumerate(grid_2x2):
        r, c = divmod(rank, 2)
        assert res["coords"] == {"data": r, "model": c}
        assert (res["row"], res["col"], res["all"]) == (r, c, rank)
        assert res["group_sizes"] == {("data",): 2, ("model",): 2,
                                      ("data", "model"): 4}
        x = np.arange(16, dtype=np.float32).reshape(8, 2)
        # psum over the row axis: the two ranks of column c
        np.testing.assert_array_equal(res["psum_row"], x * ((c + 1)
                                                            + (c + 3)))
        # reduce-scatter over (row, col): block r * 2 + c of the grid sum
        np.testing.assert_array_equal(res["scatter"],
                                      (x * 10)[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(
            res["gather"], np.repeat(np.arange(4.0), 2)[:, None]
            * np.ones((1, 2)))
        # sum over the ranks of 3 rows of (rank, rank): 3 * (0+1+4+9)
        np.testing.assert_array_equal(res["pgram"], np.full((2, 2), 42.0))
        np.testing.assert_array_equal(
            res["shard_map"], np.arange(24, dtype=np.float32).reshape(4, 6))


def test_record_step_times_sees_every_rank(grid_2x2):
    for res in grid_2x2:
        assert sorted(res["means"]) == [0, 1, 2, 3]
        for host, mean in res["means"].items():
            assert mean == pytest.approx(0.1 * (host + 1))


# ---------------------------------------------------------------------------
# two ranks: a 2x1 grid, a pod grid, an Ingested input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["2x1", "2x1_shard_c", "pod", "ingested"])
@pytest.mark.parametrize("against", ["reference", "port"])
def test_dist_2_ranks_matches_single_device_cp_als(grid_2_ranks, oracle,
                                                   name, against):
    assert_same_on_every_rank(grid_2_ranks, name)
    assert_matches(grid_2_ranks[0][name], oracle[against],
                   f"{name} vs {against}")


def test_pod_axis_joins_the_row_partition(grid_2_ranks):
    assert grid_2_ranks[0]["pod_rows"] == ("pod", "data")


# ---------------------------------------------------------------------------
# in this process: one rank, the partitioner, the gates
# ---------------------------------------------------------------------------

def test_dist_session_at_world_size_1_starts_and_ends_its_group(oracle):
    """No process group: the Session starts a one-rank gloo group for its
    grid and ends it on close; the fit matches the single-device fits."""
    import torch.distributed as dist

    inds, vals, init = case()
    t = port_tensor(inds, vals)
    cfg = RunConfig(method=MethodConfig(rank=RANK, niters=NITERS),
                    exec=ExecConfig(executor="dist"))
    assert not dist.is_initialized()
    with Session(cfg, tensor=t, device="cpu") as sess:
        dec = sess.fit()
        assert dist.get_backend() == "gloo"
        assert sess.mesh().shape == {"data": 1, "model": 1}
        direct = dist_cp_als(t, RANK, sess.mesh(), niters=NITERS,
                             init=init)
    assert not dist.is_initialized()
    assert all(a.device.type == "cpu" for a in dec.factors)
    assert_matches(_fit_out(direct), oracle["reference"], "one rank")
    local = run(RunConfig(method=MethodConfig(rank=RANK, niters=NITERS)),
                tensor=t, device="cpu")
    assert abs(float(dec.fit) - float(local.fit)) < FIT_TOL


@pytest.mark.parametrize("grid", [(2, 2), (3, 1), (1, 4)])
def test_partition_tensor_matches_reference(grid):
    from repro.core.distributed import partition_tensor as jax_partition

    from test_torch_helpers import both_tensors

    inds, vals, _ = case()
    jt, pt = both_tensors(inds, vals, DIMS)
    got = partition_tensor(pt, *grid)
    want = jax_partition(jt, *grid)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]


@pytest.mark.parametrize("impl", ["scatter", "segment"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_local_mttkrp_matches_reference(impl, mode):
    import jax.numpy as jnp

    from repro.core.distributed import _local_mttkrp as jax_local

    inds, vals, init = case()
    rows = DIMS[mode]
    got = _local_mttkrp(torch.from_numpy(inds), torch.from_numpy(vals),
                        mode, *(torch.from_numpy(a) for a in init), rows,
                        impl=impl)
    want = jax_local(jnp.asarray(inds), jnp.asarray(vals), mode,
                     *(jnp.asarray(a) for a in init), rows, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["scatter", "segment"])
def test_local_block_prepares_each_mode_once(impl):
    """The block, its padding dropped and sorted once by a segment mode's
    row, gives the per-call reduction's answer over the padded entries on
    every mode of a 2x2 grid's rank (1, 0)."""
    from repro_torch.core.distributed import local_block

    inds, vals, init = case()
    pinds, pvals, dims_p = partition_tensor(port_tensor(inds, vals), 2, 2)
    mesh = Mesh(("data", "model"), (2, 2), rank=2)
    bi, bj = dims_p[0] // 2, dims_p[1] // 2
    mine = (slice(1, 2), slice(0, 1))
    block = local_block(torch.from_numpy(pinds[mine]),
                        torch.from_numpy(pvals[mine]), mesh, dims_p,
                        (impl,) * 3)
    raw = torch.from_numpy(pinds[1, 0]).clone()
    raw[:, 0] -= bi
    fa = torch.from_numpy(np.pad(init[0], ((0, dims_p[0] - DIMS[0]),
                                           (0, 0)))[bi:])
    fb = torch.from_numpy(np.pad(init[1], ((0, dims_p[1] - DIMS[1]),
                                           (0, 0)))[:bj])
    fc = torch.from_numpy(init[2])
    real = int((pvals[1, 0] != 0).sum())
    assert all(v.shape[0] == real for v in block.vals)  # no padding
    for m, rows in enumerate((bi, bj, dims_p[2])):
        assert (block.lengths[m] is None) == (impl == "scatter")
        got = _local_mttkrp(block.inds[m], block.vals[m], m, fa, fb, fc,
                            rows, impl=impl, lengths=block.lengths[m])
        want = _local_mttkrp(raw, torch.from_numpy(pvals[1, 0]), m, fa, fb,
                             fc, rows, impl="segment")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_dist_refuses_non_dist_impls_plans_and_methods():
    from repro_torch.plan import plan_decomposition

    inds, vals, _ = case()
    t = port_tensor(inds, vals)
    mesh = Mesh(("data", "model"), (1, 1))
    with pytest.raises(ValueError, match="expresses only"):
        dist_cp_als(t, RANK, mesh, impl="cuda")
    plan = plan_decomposition(t, "linearized", rank=RANK, with_stats=False)
    with pytest.raises(ValueError, match="expresses only"):
        dist_cp_als(t, RANK, mesh, plan=plan)
    for method in ("cp_nn_hals", "tucker_hooi", "cp_als_streaming"):
        with pytest.raises(ValueError, match="supports_dist"):
            dist_cp_als(t, RANK, mesh, method=method)


def test_dist_plan_is_restricted_and_allow_inexpressible_names_the_field():
    inds, vals, _ = case()
    t = port_tensor(inds, vals)
    sess = Session(RunConfig(exec=ExecConfig(executor="dist")), tensor=t,
                   device="cpu")
    assert set(sess.plan().impls) <= set(DIST_IMPLS)
    for allow in (("cuda",), ("segment", "linearized")):
        cfg = RunConfig(plan=PlanConfig(allow=allow),
                        exec=ExecConfig(executor="dist"))
        with pytest.raises(ConfigError, match=r"plan\.allow"):
            Session(cfg, tensor=t, device="cpu").plan()


@pytest.mark.parametrize("method_kw,exec_kw,match", [
    ({"tol": 1e-4}, {}, r"method\.tol"),
    ({}, {"checkpoint_dir": "ckpt"}, "checkpoint"),
    ({"options": {"first_norm": "2"}}, {}, r"method\.options.*first_norm"),
    # the production pod mesh (launch/mesh.py) needs a world of 512 ranks
    pytest.param({}, {"multi_pod": True}, r"512 ranks",
                 id="method_kw3-exec_kw3-exec\\.multi_pod.*item 10"),
])
def test_dist_executor_refusals(method_kw, exec_kw, match):
    """Refused, and no process group is left behind (the one the session
    started for the production mesh is ended)."""
    import torch.distributed as dist

    inds, vals, _ = case()
    cfg = RunConfig(method=MethodConfig(rank=4, niters=2, **method_kw),
                    exec=ExecConfig(executor="dist", **exec_kw))
    with pytest.raises((ValueError, ConfigError), match=match):
        run(cfg, tensor=port_tensor(inds, vals), device="cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the axis rules (the JAX-free units of tests/test_dist_unit.py)
# ---------------------------------------------------------------------------

def test_cpals_axes_single_and_multipod():
    mesh = Mesh(("data", "model"), (1, 1))
    ax = cpals_axes(mesh)
    assert ax.row == ("data",) and ax.col == "model"
    assert ax.n_row == 1 and ax.n_col == 1 and ax.n_all == 1
    assert ax.all_axes == ("data", "model")
    assert ax.grid_spec() == (("data",), "model")
    assert axis_product(mesh, ("data", "model")) == 1
    assert axis_product(mesh, ()) == 1
    pod = cpals_axes(Mesh(("pod", "data", "model"), (2, 4, 2)))
    assert pod.row == ("pod", "data")
    assert (pod.n_row, pod.n_col, pod.n_all) == (8, 2, 16)
    assert pod.all_spec() == (("pod", "data", "model"),)


def test_batch_axes_pod_rule():
    assert batch_axes() == "data"
    assert batch_axes(multi_pod=True) == ("pod", "data")


def test_cpals_axes_requires_model_axis():
    with pytest.raises(ValueError):
        cpals_axes(Mesh(("data",), (1,)))


def test_mesh_coordinates_are_row_major():
    mesh = Mesh(("pod", "data", "model"), (2, 3, 2), rank=9)
    assert mesh.coords() == {"pod": 1, "data": 1, "model": 1}
    assert mesh.axis_index(("pod", "data")) == 4
    assert mesh.axis_index("model") == 1
    assert mesh.axis_index(("pod", "data", "model")) == 9
    assert mesh.axis_size(("data", "model")) == 6
    with pytest.raises(ValueError, match="no axes"):
        mesh.axis_index("tensor")
    with pytest.raises(ValueError, match="no process group"):
        mesh.group("data")


def test_record_step_times_single_process():
    mon = StragglerMonitor(window=4, threshold=1.5, patience=1, warmup=1)
    record_step_times(mon, 0.25)
    record_step_times(mon, 0.75)
    assert mon.means() == {0: 0.5}


def test_make_mesh_needs_a_process_group():
    from repro_torch.dist import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), ("data", "model"))
