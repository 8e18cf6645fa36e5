"""The port's front door, ``repro_torch.api``, alone and against the JAX
package's ``repro.api``.

On its own terms (mirroring ``tests/test_api.py``): the RunConfig schema is
the golden file, configs round-trip, the capability gate refuses with the
listing, a Session's fit equals ``methods.fit`` on the same handle bit for
bit on the CPU, stages are cached, a killed fit resumes bit for bit, the CLI
translates flags and reports errors, the legacy aliases warn once, and the
package imports neither JAX nor ``repro``.

Against the reference: the same config JSON and the same CLI argv give the
same RunConfig in both packages; port and reference Sessions started from
one step-0 checkpoint (written by the reference's manager, a copy under
each side's ``exec.checkpoint_dir``) agree within the parity tolerances
(fit 1e-4, factors 1e-2; Tucker factors as subspaces); ``plan_report``
gives the same text under the ``segment`` policy; ``ServeHandle`` answers
the same queries from the same factors.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import cli as jcli
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.methods import make_state as jax_make_state
from repro_torch import api
from repro_torch.api import (ConfigError, DataConfig, ExecConfig,
                             MethodConfig, ObsConfig, PlanConfig, RunConfig,
                             ServeConfig, ServeHandle, Session, cli,
                             get_executor, require_capability, run)
from repro_torch.ingest import ingest
from repro_torch.methods import fit as methods_fit

from test_torch_helpers import both_tensors, np_coo, np_factors, planted

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "data" / "runconfig_golden.json"
DIMS = (10, 9, 8)


def lowrank():
    """The fully observed rank-3 tensor on both sides: (jax, port)."""
    inds, vals = planted(DIMS, 3, 0)
    return both_tensors(inds, vals, DIMS)


def port_lowrank():
    return lowrank()[1]


def gen(seed=0):
    return torch.Generator(device="cpu").manual_seed(seed)


def arrays_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# RunConfig: schema, round trips, validation
# ---------------------------------------------------------------------------

def test_golden_config_file_matches_defaults():
    golden = json.loads(GOLDEN.read_text())
    assert json.loads(RunConfig().to_json()) == golden
    assert RunConfig.from_dict(golden) == RunConfig()
    assert RunConfig().to_dict() == japi.RunConfig().to_dict()


def test_roundtrip_nondefault_preserves_tuples():
    cfg = RunConfig(
        data=DataConfig(dataset="yelp", scale=0.25, reorder="degree_sort",
                        compact=True, tile=(256, 64)),
        plan=PlanConfig(policy="segment", allow=("segment", "gather_scatter")),
        method=MethodConfig(name="tucker_hooi", rank=(4, 3, 2), niters=7,
                            tol=1e-5, seed=3, options={"verbose": False}),
        exec=ExecConfig(checkpoint_dir="/tmp/ck", checkpoint_every=2,
                        monitor=True),
        obs=ObsConfig(enabled=True, trace_dir="t", routines="split",
                      xla_annotations=False),
        serve=ServeConfig(buckets=(8, 32), tenants=("a", "b")))
    back = RunConfig.from_json(cfg.to_json())
    assert back == cfg and back.to_json() == cfg.to_json()
    assert back.method.rank == (4, 3, 2) and back.data.tile == (256, 64)


CROSS_CONFIGS = [
    dict(),
    dict(plan=dict(policy="segment", allow=["segment", "gather_scatter"])),
    dict(plan=dict(policy="linearized", calibrate=True),
         data=dict(dataset="yelp", scale=0.001, reorder="degree_sort")),
    dict(method=dict(name="tucker_hooi", rank=[4, 3, 2], niters=7, seed=3),
         exec=dict(checkpoint_dir="ck", checkpoint_every=2, monitor=True)),
    dict(method=dict(name="cp_als_streaming", rank=5,
                     options={"decay": 0.9}),
         exec=dict(executor="streaming", n_chunks=4),
         obs=dict(enabled=True, trace_dir="t", http_port=0,
                  heartbeat_s=2.0)),
    dict(method=dict(name="cp_nn_hals", rank=6, tol=1e-4),
         plan=dict(policy="gather_scatter"),
         serve=dict(buckets=[8, 32], tenants=["a", "b"], port=0)),
]


@pytest.mark.parametrize("d", CROSS_CONFIGS)
def test_config_json_crosses_the_packages(d):
    """A config naming impls both registries hold means the same run to
    both packages: each one's JSON builds an equal config in the other."""
    port, ref = RunConfig.from_dict(d), japi.RunConfig.from_dict(d)
    assert port.to_dict() == ref.to_dict()
    assert japi.RunConfig.from_json(port.to_json()) == ref
    assert RunConfig.from_json(ref.to_json()) == port
    assert port.to_json() == ref.to_json()


CROSS_ARGV = [
    [],
    ["--dataset", "yelp", "--scale", "0.001", "--reorder", "degree_sort",
     "--impl", "segment", "--method", "tucker_hooi", "--rank", "3", "3", "3",
     "--iters", "4", "--seed", "9", "--option", "verbose=false"],
    ["--source", "x.tnsb", "--cache", "c", "--impl", "linearized",
     "--recalibrate", "--trace-dir", "t", "--trace-split",
     "--http-port", "0", "--heartbeat-s", "1.5", "--events-buffer", "64"],
    ["--dataset", "nell-2", "--method", "cp_als_streaming", "--executor",
     "streaming", "--n-chunks", "3", "--chunk-nnz", "4096",
     "--checkpoint-dir", "ck", "--checkpoint-every", "2", "--monitor",
     "--tenants", "a", "b", "--buckets", "8", "16", "--budget-mb", "3.5"],
]


def _cfg_from_argv(module, argv):
    p = argparse.ArgumentParser()
    module._add_config_args(p)
    return module.config_from_args(p.parse_args(argv))


@pytest.mark.parametrize("argv", CROSS_ARGV)
def test_same_cli_argv_same_config_in_both_packages(argv):
    port, ref = _cfg_from_argv(cli, argv), _cfg_from_argv(jcli, argv)
    assert port.to_dict() == ref.to_dict()


def test_tpu_impl_name_is_refused_with_the_port_kernel_named():
    with pytest.raises(ConfigError, match=r"plan\.policy.*'cuda'"):
        PlanConfig(policy="pallas")
    with pytest.raises(ConfigError, match=r"plan\.allow.*'linearized_cuda'"):
        PlanConfig(allow=("segment", "linearized_pallas"))
    # the port's kernels are valid policies here (and not in the reference)
    assert PlanConfig(policy="cuda").policy == "cuda"
    with pytest.raises(japi.ConfigError):
        japi.PlanConfig(policy="cuda")


@pytest.mark.parametrize("section,field,bad,match", [
    ("method", "rank", 0, r"method\.rank"),
    ("method", "niters", 0, r"method\.niters"),
    ("method", "name", "cp_alss", "did you mean 'cp_als'"),
    ("data", "reorder", "degree", r"data\.reorder"),
    ("data", "scale", 0.0, r"data\.scale"),
    ("exec", "executor", "locl", "did you mean 'local'"),
    ("obs", "sample_rate", 0.0, r"obs\.sample_rate"),
    ("serve", "buckets", (4, 4), r"serve\.buckets"),
])
def test_validation_names_the_field(section, field, bad, match):
    with pytest.raises(ConfigError, match=match):
        RunConfig.from_dict({section: {field: bad}})


def test_unknown_key_and_reserved_option_rejected():
    with pytest.raises(ConfigError, match="did you mean 'niters'"):
        RunConfig.from_dict({"method": {"niter": 3}})
    for reserved in ("generator", "niters", "key"):
        with pytest.raises(ConfigError, match=r"method\.options"):
            MethodConfig(options={reserved: 1})


# ---------------------------------------------------------------------------
# executors and the capability gate
# ---------------------------------------------------------------------------

def test_executor_registry_covers_the_split():
    assert get_executor("local").requires is None
    assert get_executor("dist").requires == "supports_dist"
    assert get_executor("streaming").requires == "supports_streaming"
    with pytest.raises(ValueError, match="did you mean 'local'"):
        get_executor("locl")


@pytest.mark.parametrize("method", ["cp_als", "cp_nn_hals", "tucker_hooi",
                                    "cp_als_streaming"])
def test_dist_executor_refuses_every_port_method(method):
    """Only cp_als declares supports_dist, as in the reference: the gate
    accepts it and refuses every other method with the reference's text
    and listing, at RunConfig construction too."""
    if method == "cp_als":
        assert require_capability(method, "dist").supports_dist
        RunConfig(method=MethodConfig(name=method),
                  exec=ExecConfig(executor="dist"))
        japi.require_capability(method, "dist")
        return
    with pytest.raises(ValueError, match=r"supports_dist=False\); "
                                         r"dist-capable methods: "
                                         r"\('cp_als',\)"):
        require_capability(method, "dist")
    with pytest.raises(ValueError, match="supports_dist"):
        RunConfig(method=MethodConfig(name=method), exec=ExecConfig(
            executor="dist"))


@pytest.mark.parametrize("method", ["cp_als", "cp_nn_hals", "tucker_hooi"])
def test_streaming_executor_refuses_batch_methods(method):
    with pytest.raises(ValueError, match="supports_streaming"):
        require_capability(method, "streaming")


def test_unknown_method_option_lists_the_port_names():
    cfg = RunConfig(method=MethodConfig(rank=4, niters=2,
                                        options={"genrator": 1}))
    with pytest.raises(ValueError, match=r"method\.options.*'generator'"):
        run(cfg, tensor=port_lowrank())


def test_batch_method_rejects_chunk_geometry():
    cfg = RunConfig(method=MethodConfig(rank=4, niters=2),
                    exec=ExecConfig(n_chunks=3))
    with pytest.raises(ValueError, match=r"exec\.n_chunks"):
        run(cfg, tensor=port_lowrank())


def test_streaming_rejects_pinned_plan_policy():
    cfg = RunConfig(plan=PlanConfig(policy="segment"),
                    method=MethodConfig(name="cp_als_streaming", rank=4,
                                        niters=2),
                    exec=ExecConfig(executor="streaming"))
    with pytest.raises(ConfigError, match=r"plan\.policy"):
        run(cfg, tensor=port_lowrank())


# ---------------------------------------------------------------------------
# Session == methods.fit, bit for bit on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,rank", [
    ("cp_als", 4), ("cp_nn_hals", 4), ("tucker_hooi", (3, 3, 3)),
])
def test_session_matches_methods_fit_bit_exactly(method, rank):
    t = port_lowrank()
    cfg = RunConfig(method=MethodConfig(name=method, rank=rank, niters=5))
    dec = run(cfg, tensor=t, device="cpu")
    ref = methods_fit(ingest(t), rank, method=method, niters=5,
                      generator=gen(), impl="auto")
    arrays_equal(dec.fit, ref.fit)
    for a, b in zip(dec.factors, ref.factors):
        arrays_equal(a, b)


def test_streaming_executor_matches_methods_fit_bit_exactly():
    t = port_lowrank()
    cfg = RunConfig(method=MethodConfig(name="cp_als_streaming", rank=4,
                                        niters=5),
                    exec=ExecConfig(executor="streaming", n_chunks=3))
    dec = run(cfg, tensor=t)
    ref = methods_fit(t, 4, method="cp_als_streaming", niters=5,
                      generator=gen(), n_chunks=3)
    arrays_equal(dec.fit, ref.fit)
    for a, b in zip(dec.factors, ref.factors):
        arrays_equal(a, b)


def test_session_dataset_and_reorder_match_direct_ingest():
    """A synthetic paper replica drawn on the session's device through
    degree_sort: Session == direct ingest + methods.fit, factors in the
    original labels on both sides."""
    from repro_torch.core import paper_dataset

    cfg = RunConfig(data=DataConfig(dataset="yelp", scale=0.0005, seed=3,
                                    reorder="degree_sort"),
                    method=MethodConfig(rank=5, niters=3))
    sess = Session(cfg, device="cpu")
    dec = sess.fit()
    t = paper_dataset("yelp", 3, scale=0.0005, device="cpu")
    ref = methods_fit(ingest(t, reorder="degree_sort"), 5, niters=3,
                      generator=gen(), impl="auto")
    arrays_equal(dec.fit, ref.fit)
    for a, b, d in zip(dec.factors, ref.factors, t.dims):
        assert a.shape[0] == d
        arrays_equal(a, b)


def test_stages_are_lazy_and_cached():
    sess = Session(RunConfig(method=MethodConfig(rank=4, niters=3)),
                   tensor=port_lowrank())
    ing = sess.ingest()
    assert sess.ingest() is ing
    plan = sess.plan()
    assert sess.plan() is plan
    dec = sess.fit()
    assert sess.fit() is dec
    again = sess.fit(force=True)
    assert again is not dec
    arrays_equal(again.fit, dec.fit)  # the same generator seed each fit
    assert sess.serve_handle() is sess.serve_handle()


def test_session_adopts_prebuilt_ingested_handle():
    t = port_lowrank()
    ing = ingest(t)
    cfg = RunConfig(method=MethodConfig(rank=4, niters=3))
    sess = Session(cfg, tensor=ing)
    assert sess.ingest() is ing and sess.device.type == "cpu"
    arrays_equal(sess.fit().fit, run(cfg, tensor=t).fit)
    with pytest.raises(ValueError, match="names no data"):
        Session(RunConfig(), device="cpu").ingest()
    with pytest.raises(ValueError, match="already names a data source"):
        Session(RunConfig(data=DataConfig(dataset="yelp")), tensor=t)


def test_session_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    """No fallback: without a card a session that does not ask for the CPU
    raises; an in-memory tensor keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RunConfig(data=DataConfig(dataset="yelp", scale=0.0005))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["fit", "--dataset", "yelp", "--scale", "0.0005",
                  "--dryrun"])
    assert Session(cfg, device="cpu").device.type == "cpu"
    assert Session(RunConfig(), tensor=port_lowrank()).device.type == "cpu"


# ---------------------------------------------------------------------------
# checkpoint / resume through the Session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,rank", [
    ("cp_als", 4), ("cp_nn_hals", 4), ("tucker_hooi", (3, 3, 3)),
    ("cp_als_streaming", 4),
])
def test_session_kill_and_resume_bit_exact(tmp_path, method, rank):
    t = port_lowrank()
    nc = 3 if method == "cp_als_streaming" else None
    full = run(RunConfig(method=MethodConfig(name=method, rank=rank,
                                             niters=8),
                         exec=ExecConfig(n_chunks=nc)), tensor=t)
    ck = str(tmp_path / "ck")
    killed = RunConfig(method=MethodConfig(name=method, rank=rank, niters=3),
                       exec=ExecConfig(checkpoint_dir=ck, n_chunks=nc))
    run(killed, tensor=t)
    resumed_cfg = RunConfig.from_json(killed.replace(method=MethodConfig(
        name=method, rank=rank, niters=8)).to_json())
    sess = Session(resumed_cfg, tensor=t)
    state = sess.resume_state()
    assert state is not None and int(state.iteration) == 3
    resumed = sess.fit()
    for a, b in zip(full.factors, resumed.factors):
        arrays_equal(a, b)
    arrays_equal(full.fit, resumed.fit)


def test_resume_rejects_method_rank_and_seed_mismatch(tmp_path):
    t = port_lowrank()
    ck = str(tmp_path / "ck")
    run(RunConfig(method=MethodConfig(rank=4, niters=2),
                  exec=ExecConfig(checkpoint_dir=ck)), tensor=t)
    with pytest.raises(ValueError, match=r"method\.rank.*4.*8"):
        run(RunConfig(method=MethodConfig(rank=8, niters=4),
                      exec=ExecConfig(checkpoint_dir=ck)), tensor=t)
    with pytest.raises(ValueError, match=r"method\.seed"):
        run(RunConfig(method=MethodConfig(rank=4, niters=4, seed=9),
                      exec=ExecConfig(checkpoint_dir=ck)), tensor=t)
    other = RunConfig(method=MethodConfig(name="cp_nn_hals", rank=4,
                                          niters=4),
                      exec=ExecConfig(checkpoint_dir=ck))
    with pytest.raises(ValueError, match="written by method"):
        Session(other, tensor=t).resume_state()


# ---------------------------------------------------------------------------
# port Session against reference Session, from one step-0 checkpoint
# ---------------------------------------------------------------------------

def _orthonormal(dims, ranks, seed):
    rng = np.random.default_rng(seed)
    return [np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
            for d, r in zip(dims, ranks)]


def _shared_step0(tmp_path, method, rank, factors, aux):
    """A step-0 DecompState written by the reference's manager, copied
    under each side's checkpoint dir: (jax dir, port dir)."""
    zero = jnp.asarray(np.float32(0.0))
    state = jax_make_state([jnp.asarray(a) for a in factors],
                           {k: jnp.asarray(v) for k, v in aux.items()},
                           zero, zero, 0)
    src = tmp_path / "src"
    JaxCheckpointManager(src, async_save=False).save(
        0, state, extra={"method": method,
                         "rank": list(rank) if isinstance(rank, tuple)
                         else rank, "seed": 0})
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, jdir)
    shutil.copytree(src, pdir)
    return str(jdir), str(pdir)


def _both_sessions(tmp_path, method, rank, factors, aux, niters,
                   tensors):
    jdir, pdir = _shared_step0(tmp_path, method, rank, factors, aux)
    jt, pt = tensors
    jcfg = japi.RunConfig(method=japi.MethodConfig(name=method, rank=rank,
                                                   niters=niters),
                          exec=japi.ExecConfig(checkpoint_dir=jdir))
    pcfg = RunConfig(method=MethodConfig(name=method, rank=rank,
                                         niters=niters),
                     exec=ExecConfig(checkpoint_dir=pdir))
    jsess = japi.Session.from_config(jcfg, tensor=jt)
    psess = Session(pcfg, tensor=pt, device="cpu")
    # both resume the shared step 0: the same initial factors
    assert int(jsess.resume_state().iteration) == 0
    state = psess.resume_state()
    assert int(state.iteration) == 0
    for a, b in zip(state.factors, factors):
        np.testing.assert_array_equal(a.numpy(), b)
    return jsess.fit(), psess.fit()


def test_port_session_matches_reference_session_cp(tmp_path):
    factors = np_factors(DIMS, 4, 7)
    jd, pd = _both_sessions(tmp_path, "cp_als", 4, factors,
                            {"lmbda": np.ones(4, np.float32)}, 8, lowrank())
    assert abs(float(pd.fit) - float(jd.fit)) < 1e-4
    for a, b in zip(pd.factors, jd.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2,
                                   atol=1e-2)
    np.testing.assert_allclose(pd.lmbda.numpy(), np.asarray(jd.lmbda),
                               rtol=1e-2, atol=1e-2)


def test_port_session_matches_reference_session_tucker(tmp_path):
    """On a sparse tensor: on an exactly low-rank one the fit,
    1 - sqrt(||X||^2 - ||G||^2) / ||X||, takes the square root of a float32
    cancellation near 0 in either package, which is rounding, not parity."""
    ranks = (3, 3, 3)
    factors = _orthonormal(DIMS, ranks, 8)
    inds, vals = np_coo(DIMS, 300, 9)
    jd, pd = _both_sessions(tmp_path, "tucker_hooi", ranks, factors, {}, 5,
                            both_tensors(inds, vals, DIMS))
    assert abs(float(pd.fit) - float(jd.fit)) < 1e-4
    # SVD signs differ between the libraries: compare subspaces
    for a, b in zip(pd.factors, jd.factors):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, atol=1e-2)


# ---------------------------------------------------------------------------
# plan_report and ServeHandle against the reference
# ---------------------------------------------------------------------------

def test_plan_report_same_text_as_reference():
    """The same tensor under the segment policy, which both packages
    register: the same table, footer included; no column differs."""
    inds, vals = np_coo((30, 20, 25), 900, 4, skew=1.0)
    jt, pt = both_tensors(inds, vals, (30, 20, 25))
    for reorder in ("identity", "degree_sort"):
        jcfg = japi.RunConfig(data=japi.DataConfig(reorder=reorder),
                              plan=japi.PlanConfig(policy="segment"),
                              method=japi.MethodConfig(rank=8))
        pcfg = RunConfig(data=DataConfig(reorder=reorder),
                         plan=PlanConfig(policy="segment"),
                         method=MethodConfig(rank=8))
        want = japi.Session.from_config(jcfg, tensor=jt).plan_report()
        got = Session(pcfg, tensor=pt).plan_report()
        assert got == want
        assert "# provenance:" in got


def test_plan_report_same_text_for_tucker_kernel():
    inds, vals = np_coo((30, 20, 25), 900, 5, skew=1.0)
    jt, pt = both_tensors(inds, vals, (30, 20, 25))
    jcfg = japi.RunConfig(plan=japi.PlanConfig(policy="segment"),
                          method=japi.MethodConfig(name="tucker_hooi",
                                                   rank=(3, 4, 2)))
    pcfg = RunConfig(plan=PlanConfig(policy="segment"),
                     method=MethodConfig(name="tucker_hooi", rank=(3, 4, 2)))
    assert (Session(pcfg, tensor=pt).plan_report()
            == japi.Session.from_config(jcfg, tensor=jt).plan_report())


def _both_cp_decomps(dims, rank, seed):
    from repro.core.cpals import CPDecomp as JaxCPDecomp
    from repro_torch.core.cpals import CPDecomp

    factors = np_factors(dims, rank, seed)
    lmbda = np.random.default_rng(seed + 1).uniform(
        0.5, 2.0, rank).astype(np.float32)
    jd = JaxCPDecomp(factors=tuple(jnp.asarray(a) for a in factors),
                     lmbda=jnp.asarray(lmbda), fit=jnp.asarray(0.5))
    pd = CPDecomp(factors=tuple(torch.from_numpy(a) for a in factors),
                  lmbda=torch.from_numpy(lmbda), fit=torch.tensor(0.5))
    return jd, pd


def test_serve_handle_matches_reference_queries_and_top_k():
    dims = (40, 30, 20)
    jd, pd = _both_cp_decomps(dims, 6, 11)
    jh, ph = japi.ServeHandle(jd, dims), ServeHandle(pd, dims)
    rng = np.random.default_rng(12)
    coords = np.stack([rng.integers(0, d, 200) for d in dims],
                      axis=1).astype(np.int32)
    np.testing.assert_allclose(ph.query(coords).numpy(),
                               np.asarray(jh.query(coords)),
                               rtol=1e-5, atol=1e-6)
    for user, k, modes in ((3, 5, (0, 1)), (7, 30, (0, 1)),
                           (2, 4, (2, 0))):
        js, ji = jh.top_k_for_user(user, k, user_mode=modes[0],
                                   item_mode=modes[1])
        ps, pi = ph.top_k_for_user(user, k, user_mode=modes[0],
                                   item_mode=modes[1])
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_serve_handle_tucker_top_k_matches_reference():
    from repro.methods.tucker_hooi import TuckerDecomp as JaxTucker
    from repro_torch.methods import TuckerDecomp

    dims, ranks = (30, 25, 20), (3, 4, 2)
    factors = _orthonormal(dims, ranks, 13)
    core = np.random.default_rng(14).standard_normal(ranks).astype(
        np.float32)
    jd = JaxTucker(core=jnp.asarray(core),
                   factors=tuple(jnp.asarray(a) for a in factors),
                   fit=jnp.asarray(0.5))
    pd = TuckerDecomp(core=torch.from_numpy(core),
                      factors=tuple(torch.from_numpy(a) for a in factors),
                      fit=torch.tensor(0.5))
    js, ji = japi.ServeHandle(jd, dims).top_k_for_user(4, 6)
    ps, pi = ServeHandle(pd, dims).top_k_for_user(4, 6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_serve_handle_reconstructs_known_entries():
    t = port_lowrank()
    handle = Session(RunConfig(method=MethodConfig(rank=6, niters=20)),
                     tensor=t).serve_handle()
    assert isinstance(handle, ServeHandle) and handle.dims == t.dims
    got = handle.query(t.inds[:64].numpy())
    np.testing.assert_allclose(got.numpy(), t.vals[:64].numpy(), rtol=0.05,
                               atol=0.05)
    bench = handle.benchmark(queries=256, batch=64)
    assert bench["queries"] == 256 and bench["qps"] > 0
    assert bench["latency_ms"]["count"] == 4


def test_queries_helpers():
    from repro_torch.core.cpals import CPDecomp
    from repro_torch.serve import bucket_for, pad_rows, resident_bytes

    assert bucket_for(5, (4, 16, 64)) == 16
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        bucket_for(65, (4, 16, 64))
    x = np.ones((3, 2), np.int32)
    assert pad_rows(x, 5).shape == (5, 2) and pad_rows(x, 2) is x
    dec = CPDecomp(factors=(torch.zeros(10, 4), torch.zeros(5, 4)),
                   lmbda=torch.ones(4), fit=torch.tensor(0.0))
    assert resident_bytes(dec) == (10 * 4 + 5 * 4 + 4) * 4
    with pytest.raises(ValueError, match="distinct modes"):
        ServeHandle(dec, (10, 5)).top_k_for_user(0, 3, user_mode=1,
                                                 item_mode=1)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_list_matrices_come_from_registries(capsys):
    assert cli.main(["--list-methods"]) == 0
    out = capsys.readouterr().out
    for name in ("cp_als", "cp_nn_hals", "tucker_hooi", "cp_als_streaming",
                 "local", "dist", "streaming"):
        assert name in out
    assert cli.main(["--list-impls"]) == 0
    out = capsys.readouterr().out
    for name in ("gather_scatter", "segment", "cuda", "linearized_cuda",
                 "rowloop", "mttkrp", "ttmc"):
        assert name in out
    assert "pallas" not in out


def test_cli_fit_on_cpu_prints_plan_fit_and_writes_factors(tmp_path,
                                                          capsys):
    out_path = tmp_path / "f.npz"
    rc = cli.main(["fit", "--dataset", "yelp", "--scale", "0.0005",
                   "--rank", "4", "--iters", "2", "--impl", "segment",
                   "--device", "cpu", "--out", str(out_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "# plan: policy=segment backend=cpu rank=4" in out
    assert "fit=" in out and "wall=" in out
    saved = np.load(out_path)
    assert saved["factor_0"].shape[1] == 4 and saved["lmbda"].shape == (4,)


def test_cli_dryrun_ingest_plan_and_serve(tmp_path, capsys):
    cfg = RunConfig(data=DataConfig(dataset="yelp", scale=0.0005),
                    method=MethodConfig(rank=8, niters=2))
    f = tmp_path / "run.json"
    f.write_text(cfg.to_json())
    assert cli.main(["fit", "--config", str(f), "--rank", "4", "--dryrun",
                     "--device", "cpu"]) == 0
    assert "plan only, skipping execution" in capsys.readouterr().out
    assert cli.main(["ingest", "--dataset", "yelp", "--scale", "0.0005",
                     "--device", "cpu"]) == 0
    assert "cache_hit=False" in capsys.readouterr().out
    assert cli.main(["plan", "--dataset", "yelp", "--scale", "0.0005",
                     "--device", "cpu"]) == 0
    assert "| mode | method |" in capsys.readouterr().out
    assert cli.main(["serve", "--dataset", "yelp", "--scale", "0.0005",
                     "--rank", "4", "--iters", "2", "--queries", "256",
                     "--batch", "64", "--device", "cpu"]) == 0
    assert "vals/s, p50" in capsys.readouterr().out


def test_cli_errors_are_formatted(tmp_path, capsys):
    rc = cli.main(["fit", "--dataset", "yelp", "--method", "cp_alss",
                   "--dryrun", "--device", "cpu"])
    assert rc == 2 and "did you mean 'cp_als'" in capsys.readouterr().err
    rc = cli.main(["fit", "--source", str(tmp_path / "missing.tns"),
                   "--dryrun", "--device", "cpu"])
    assert rc == 2 and "error:" in capsys.readouterr().err
    rc = cli.main(["fit", "--dataset", "yelp", "--option", "decay",
                   "--dryrun", "--device", "cpu"])
    assert rc == 2 and "KEY=VALUE" in capsys.readouterr().err
    f = tmp_path / "bad.json"
    f.write_text('{"data": []}')
    rc = cli.main(["fit", "--config", str(f), "--dataset", "yelp",
                   "--dryrun", "--device", "cpu"])
    assert rc == 2 and "wants a mapping" in capsys.readouterr().err
    assert cli.main([]) == 2


def test_imports_leave_no_jax_or_reference_and_main_runs():
    """The port's front door and observability import neither JAX nor the
    JAX package, and ``python -m repro_torch`` runs in a fresh
    interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, runpy\n"
            "import repro_torch.api, repro_torch.obs, repro_torch.utils\n"
            "import repro_torch.serve, repro_torch.dist\n"
            "import repro_torch.serve.server, repro_torch.core.distributed\n"
            "sys.argv = ['repro_torch', '--list-methods']\n"
            "try:\n"
            "    runpy.run_module('repro_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or\n"
            "             m.startswith(('jax.', 'repro.')))\n"
            "print('LOADED', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
    assert "cp_als_streaming" in r.stdout
    r = subprocess.run([sys.executable, "-m", "repro_torch", "--list-impls"],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "linearized_cuda" in r.stdout


# ---------------------------------------------------------------------------
# the legacy aliases
# ---------------------------------------------------------------------------

def test_legacy_cp_als_warns_deprecation_once():
    from repro_torch.core import cpals as cpals_mod

    t = port_lowrank()
    cpals_mod._warned_legacy = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        first = cpals_mod.cp_als(t, rank=3, niters=1)
        cpals_mod.cp_als(t, rank=3, niters=1)
    depr = [x for x in w if issubclass(x.category, DeprecationWarning)
            and "repro_torch.api" in str(x.message)]
    assert len(depr) == 1
    arrays_equal(first.fit, methods_fit(t, 3, niters=1).fit)


def test_legacy_build_csf_tiled_and_impls():
    from repro_torch import core

    t = port_lowrank()
    a, b = core.build_csf_tiled(t, 1), core.build_csf(t, 1)
    for name in ("row_ids", "other_ids", "vals"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert core.IMPLS == tuple(core.REGISTRY)
    assert "cuda" in core.IMPLS and "pallas" not in core.IMPLS
    assert api.__all__ == japi.__all__
