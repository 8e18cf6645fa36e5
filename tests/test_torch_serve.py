"""The port's serving layer, ``repro_torch.serve``, against the JAX
package's ``repro.serve`` (mirroring ``tests/test_serve.py``).

Both sides serve the same factors: the reference fits its CP and Tucker
models once, and the port's decompositions are built from those factors
by value.  Tolerances: ``values_at`` and ``top_k`` scores within 1e-5
(float32 gathers and one small GEMM summed in another order), items
equal; the two daemons' JSON bodies key for key.  On the CPU a
``TenantModel`` runs each bucket variant eagerly and counts its first
build, which is what ``compile_count`` pins here (the card captures a CUDA
graph per bucket: ``tests/test_torch_cuda.py``).
"""
import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref
from concurrent.futures import wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.api import MethodConfig as JMethodConfig
from repro.api import RunConfig as JRunConfig
from repro.api import ServeConfig as JServeConfig
from repro.api import Session as JSession
from repro.methods import fit as jfit
from repro.obs.metrics import scoped_registry as jscoped_registry
from repro_torch import serve
from repro_torch.api import MethodConfig, RunConfig, ServeConfig, Session, cli
from repro_torch.core.cpals import CPDecomp
from repro_torch.methods.tucker_hooi import TuckerDecomp
from repro_torch.obs.metrics import scoped_registry
from repro_torch.serve import (BatchQueue, DecompServer, ModelRegistry,
                               ServeDaemon, TenantModel, bucket_for,
                               make_score_fn, pad_rows, resident_bytes)

from test_torch_helpers import both_tensors, planted

DIMS = (10, 9, 8)
KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def lowrank():
    """The fully observed rank-3 tensor on both sides: (jax, port)."""
    inds, vals = planted(DIMS, 3, 0)
    return both_tensors(inds, vals, DIMS)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cps():
    """The reference's fitted CP model and the port's copy of it."""
    jdec = jfit(lowrank()[0], 4, niters=15, key=KEY)
    return jdec, CPDecomp(factors=tuple(_t(f) for f in jdec.factors),
                          lmbda=_t(jdec.lmbda), fit=_t(jdec.fit))


@pytest.fixture(scope="module")
def tuckers():
    jdec = jfit(lowrank()[0], 3, method="tucker_hooi", niters=10, key=KEY)
    return jdec, TuckerDecomp(core=_t(jdec.core),
                              factors=tuple(_t(f) for f in jdec.factors),
                              fit=_t(jdec.fit))


@pytest.fixture
def cp(cps):
    return cps[1]


@pytest.fixture
def tucker(tuckers):
    return tuckers[1]


def coords_of(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, d, n) for d in DIMS],
                    -1).astype(np.int32)


# ---------------------------------------------------------------------------
# bucketed padding and the query vocabulary
# ---------------------------------------------------------------------------

def test_bucket_for_picks_smallest_fitting():
    for n in range(1, 257):
        assert bucket_for(n, (16, 64, 256)) == jserve.bucket_for(
            n, (16, 64, 256))
    with pytest.raises(ValueError, match="chunk before bucketing"):
        bucket_for(257, (16, 64, 256))
    assert serve.QUERY_KINDS == jserve.QUERY_KINDS
    assert serve.DEFAULT_BUCKETS == jserve.DEFAULT_BUCKETS
    assert serve.__all__ == jserve.__all__


def test_pad_rows_zero_pads_and_noops_at_size():
    x = np.ones((3, 2), dtype=np.float32)
    padded = pad_rows(x, 8)
    assert isinstance(padded, np.ndarray)
    np.testing.assert_array_equal(padded, jserve.pad_rows(x, 8))
    assert pad_rows(x, 3) is x


@pytest.mark.parametrize("kind", ["cp", "tucker"])
def test_score_fn_matches_dense_marginal(kind, cps, tuckers):
    jdec, dec = cps if kind == "cp" else tuckers
    want = np.asarray(jserve.make_score_fn(jdec)(jnp.arange(10)))
    got = make_score_fn(dec)(torch.arange(10)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dense = dec.to_dense().sum(dim=2).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


def test_score_fn_nondefault_modes(cps):
    jdec, dec = cps
    want = np.asarray(jserve.make_score_fn(jdec, user_mode=2, item_mode=0)(
        jnp.arange(8)))
    got = make_score_fn(dec, user_mode=2, item_mode=0)(torch.arange(8))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_score_fn_rejects_bad_modes_and_types(cp):
    with pytest.raises(ValueError, match="distinct modes"):
        make_score_fn(cp, user_mode=1, item_mode=1)
    with pytest.raises(ValueError, match="distinct modes"):
        make_score_fn(cp, user_mode=0, item_mode=3)
    with pytest.raises(TypeError, match="CP .* or Tucker"):
        make_score_fn(object())


def test_top_k_clamps_k_to_items(cp):
    model = TenantModel(cp, DIMS, buckets=(4,))
    scores, items = model.top_k(np.arange(2), 99)
    assert scores.shape == (2, 9) and items.shape == (2, 9)


def test_resident_bytes_counts_factors_and_aux(cps, tuckers):
    for jdec, dec in (cps, tuckers):
        assert resident_bytes(dec) == jserve.resident_bytes(jdec)


# ---------------------------------------------------------------------------
# TenantModel: one variant per bucket
# ---------------------------------------------------------------------------

def test_values_at_compiles_once_per_bucket(cps):
    jdec, dec = cps
    model = TenantModel(dec, DIMS, buckets=(4, 16))
    jmodel = jserve.TenantModel(jdec, DIMS, buckets=(4, 16))
    for i, n in enumerate((1, 3, 4, 5, 16, 2, 40, 16, 7)):
        coords = coords_of(n, i)
        got = model.values_at(coords)
        assert isinstance(got, np.ndarray) and got.shape == (n,)
        np.testing.assert_allclose(got, np.asarray(jmodel.values_at(coords)),
                                   **TOL)
    assert model.compile_count["values_at"] == 2
    assert model.compile_count == jmodel.compile_count
    assert model.variant_keys == (("values_at", 4), ("values_at", 16))


def test_top_k_compiles_once_per_bucket_and_k(cps):
    jdec, dec = cps
    model = TenantModel(dec, DIMS, buckets=(4, 16))
    jmodel = jserve.TenantModel(jdec, DIMS, buckets=(4, 16))
    for n in (1, 2, 4, 9, 16, 3):
        users = np.arange(n) % DIMS[0]
        scores, items = model.top_k(users, 3)
        jscores, jitems = jmodel.top_k(jnp.asarray(users), 3)
        np.testing.assert_allclose(scores, np.asarray(jscores), **TOL)
        np.testing.assert_array_equal(items, np.asarray(jitems))
    assert model.compile_count["top_k"] == 2  # buckets 4 and 16, one k
    model.top_k(np.arange(2), 5)  # a new k -> one more variant
    jmodel.top_k(jnp.arange(2), 5)
    assert model.compile_count["top_k"] == 3
    assert model.compile_count == jmodel.compile_count


def test_oversize_batch_chunks_at_largest_bucket(cps):
    jdec, dec = cps
    t = lowrank()[1]
    model = TenantModel(dec, DIMS, buckets=(4, 8))
    jmodel = jserve.TenantModel(jdec, DIMS, buckets=(4, 8))
    coords = t.inds[:30].numpy()
    got = model.values_at(coords)
    assert got.shape == (30,)
    np.testing.assert_allclose(got, np.asarray(jmodel.values_at(coords)),
                               **TOL)
    np.testing.assert_allclose(got, dec.values_at(t.inds[:30]).numpy(),
                               **TOL)
    users = np.arange(10) % 10
    scores, items = model.top_k(users, 3)
    jscores, jitems = jmodel.top_k(jnp.asarray(users), 3)
    assert scores.shape == (10, 3)
    np.testing.assert_allclose(scores, np.asarray(jscores), **TOL)
    np.testing.assert_array_equal(items, np.asarray(jitems))
    assert model.compile_count["values_at"] <= 2


def test_out_of_range_ids_are_refused_on_the_host(cp):
    """The reference's gathers clamp an out-of-range id; the port refuses
    it before any device work (on the card the gather would be a
    device-side assert), and the daemon answers 400."""
    model = TenantModel(cp, DIMS, buckets=(4,))
    with pytest.raises(ValueError, match="user ids outside"):
        model.top_k(np.array([0, 10]), 2)
    with pytest.raises(ValueError, match="coordinates outside"):
        model.values_at(np.array([[0, 9, 0]], np.int32))
    with pytest.raises(ValueError, match=r"\(n, 3\) coords"):
        model.values_at(np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="k >= 1"):
        model.top_k(np.arange(2), 0)
    assert model.compile_count == {"values_at": 0, "top_k": 0}
    with DecompServer(buckets=(4,)) as srv:
        srv.publish("web", cp, DIMS)
        with ServeDaemon(srv, port=0) as daemon:
            code, body = _http(daemon.url + "/v1/top_k?tenant=web&user=10")
    assert code == 400 and "outside the dims" in json.loads(body)["error"]


def test_warmup_builds_the_smallest_values_at_bucket(cp):
    model = TenantModel(cp, DIMS, buckets=(8, 4))
    model.warmup()
    assert model.variant_keys == (("values_at", 4),)
    assert model.compile_count == {"values_at": 1, "top_k": 0}


# ---------------------------------------------------------------------------
# ModelRegistry: hot-swap + LRU eviction
# ---------------------------------------------------------------------------

def test_registry_swap_is_atomic_handle_replacement(cp, tucker):
    reg = ModelRegistry(buckets=(4,))
    e1 = reg.publish("t", cp)
    old_model = reg.get("t").model
    e2 = reg.publish("t", tucker)
    assert e2.generation == e1.generation + 1
    assert reg.get("t").model is not old_model
    # the old handle still answers: in-flight batches finish on it
    assert old_model.values_at(np.zeros((1, 3), np.int32)).shape == (1,)


def test_registry_frees_a_swapped_model_with_its_last_reference(cp):
    reg = ModelRegistry(buckets=(4,))
    reg.publish("t", cp).model.values_at(np.zeros((4, 3), np.int32))
    gone = weakref.ref(reg.get("t").model)
    reg.publish("t", cp)
    gc.collect()
    assert gone() is None


def test_registry_unknown_tenant_names_residents(cp):
    reg = ModelRegistry()
    reg.publish("a", cp)
    with pytest.raises(KeyError, match=r"not published.*'a'"):
        reg.get("b")


def test_registry_lru_eviction_respects_budget(cps):
    jdec, dec = cps
    one = resident_bytes(dec)
    runs = []
    for registry_cls, scope, d in ((ModelRegistry, scoped_registry, dec),
                                   (jserve.ModelRegistry, jscoped_registry,
                                    jdec)):
        with scope() as metrics:
            reg = registry_cls(budget_bytes=2 * one, buckets=(4,))
            reg.publish("a", d)
            reg.publish("b", d)
            reg.get("a")  # a is now more recently used than b
            reg.publish("c", d)  # over budget -> evict LRU = b
            assert "a" in reg and "c" in reg and "b" not in reg
            with pytest.raises(KeyError, match="evicted"):
                reg.get("b")
            assert reg.resident_bytes() == 2 * one
            # the tenant just published is never the victim
            reg2 = registry_cls(budget_bytes=one // 2, buckets=(4,))
            reg2.publish("only", d)
            assert "only" in reg2
            runs.append((sorted(reg.tenants()), reg.evicted,
                         metrics.snapshot()))
    assert runs[0] == runs[1]


def test_registry_republish_after_eviction_clears_state(cp):
    one = resident_bytes(cp)
    reg = ModelRegistry(budget_bytes=one, buckets=(4,))
    reg.publish("a", cp)
    reg.publish("b", cp)  # evicts a
    assert "a" not in reg
    reg.publish("a", cp)  # back in (evicts b)
    assert "a" in reg and reg.get("a").generation == 1


# ---------------------------------------------------------------------------
# BatchQueue: coalescing, futures, failure delivery
# ---------------------------------------------------------------------------

def _queue(cp, **kw):
    reg = ModelRegistry(buckets=kw.pop("buckets", (4, 16)))
    reg.publish("t", cp)
    return reg, BatchQueue(reg, buckets=reg.buckets, **kw)


def test_queue_resolves_futures_with_correct_slices(cps):
    jdec, dec = cps
    t = lowrank()[1]
    reg, q = _queue(dec, max_wait_ms=5.0)
    try:
        futs = [q.submit("t", "values_at", t.inds[i:i + 3].numpy())
                for i in range(0, 30, 3)]
        for i, f in enumerate(futs):
            want = jdec.values_at(jnp.asarray(t.inds[3 * i:3 * i + 3]))
            np.testing.assert_allclose(f.result(timeout=10),
                                       np.asarray(want), **TOL)
    finally:
        q.stop()


def test_queue_coalesces_within_window(cp):
    t = lowrank()[1]
    reg, q = _queue(cp, max_wait_ms=200.0)
    try:
        futs = [q.submit("t", "values_at", t.inds[i:i + 1].numpy())
                for i in range(8)]
        wait(futs, timeout=10)
        assert q.batches_executed < 8
    finally:
        q.stop()


def test_queue_mixed_kinds_and_tenants_do_not_comingle(cp, tucker):
    reg = ModelRegistry(buckets=(16,))
    reg.publish("x", cp)
    reg.publish("y", tucker)
    q = BatchQueue(reg, buckets=(16,), max_wait_ms=50.0, workers=2)
    try:
        fv = q.submit("x", "values_at", np.zeros((2, 3), np.int32))
        fk = q.submit("x", "top_k", np.arange(2), k=3)
        fy = q.submit("y", "top_k", np.arange(2), k=3)
        assert fv.result(timeout=10).shape == (2,)
        sx, ix = fk.result(timeout=10)
        sy, iy = fy.result(timeout=10)
        assert ix.shape == (2, 3) and iy.shape == (2, 3)
        assert not np.allclose(sx, sy)  # different models answered
    finally:
        q.stop()


def test_queue_delivers_failures_via_futures(cp):
    reg, q = _queue(cp, max_wait_ms=1.0)
    try:
        f = q.submit("nobody", "values_at", np.zeros((1, 3), np.int32))
        with pytest.raises(KeyError, match="not published"):
            f.result(timeout=10)
    finally:
        q.stop()


def test_queue_submit_validation(cp):
    reg, q = _queue(cp)
    try:
        with pytest.raises(ValueError, match="unknown query kind"):
            q.submit("t", "frobnicate", np.zeros((1, 3), np.int32))
        with pytest.raises(ValueError, match=r"\(n, order\)"):
            q.submit("t", "values_at", np.zeros(3, np.int32))
        with pytest.raises(ValueError, match="k >= 1"):
            q.submit("t", "top_k", np.arange(2))
    finally:
        q.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        q.submit("t", "values_at", np.zeros((1, 3), np.int32))


def test_queue_stop_drains_pending(cp):
    t = lowrank()[1]
    reg, q = _queue(cp, max_wait_ms=500.0)
    futs = [q.submit("t", "values_at", t.inds[i:i + 2].numpy())
            for i in range(0, 20, 2)]
    q.stop()  # must not strand the already-submitted futures
    for f in futs:
        assert f.result(timeout=1) is not None


# ---------------------------------------------------------------------------
# DecompServer: concurrency, hot-swap under load, metrics
# ---------------------------------------------------------------------------

def test_server_concurrent_clients_compile_once_per_bucket(cps):
    """4 threads x mixed values_at/top_k: every answer equal to the
    reference's, and never more than one variant per (bucket[, k])."""
    jdec, dec = cps
    t = lowrank()[1]
    want_vals = np.asarray(jdec.values_at(jnp.asarray(t.inds)))
    want_items = np.asarray(jax.lax.top_k(
        jserve.make_score_fn(jdec)(jnp.arange(10)), 3)[1])
    with scoped_registry():
        with DecompServer(buckets=(4, 16), max_wait_ms=2.0,
                          workers=2) as srv:
            srv.publish("t", dec, DIMS)
            errors = []

            def client(seed):
                rng = np.random.default_rng(seed)
                try:
                    for _ in range(12):
                        if rng.random() < 0.5:
                            idx = rng.integers(0, t.nnz, rng.integers(1, 9))
                            got = srv.values_at("t", t.inds.numpy()[idx])
                            np.testing.assert_allclose(got, want_vals[idx],
                                                       **TOL)
                        else:
                            u = int(rng.integers(0, 10))
                            _, items = srv.top_k_for_user("t", u, k=3)
                            np.testing.assert_array_equal(items,
                                                          want_items[u])
                except Exception as e:  # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(s,))
                       for s in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not errors, errors
            model = srv.registry.get("t").model
            assert model.compile_count["values_at"] <= 2
            assert model.compile_count["top_k"] <= 2


def test_server_hot_swap_drops_zero_inflight_queries(cp, tucker):
    t = lowrank()[1]
    with DecompServer(buckets=(4, 16), max_wait_ms=1.0, workers=2) as srv:
        srv.publish("t", cp, DIMS)
        stop = threading.Event()
        futs = []

        def client():
            while not stop.is_set():
                futs.append(srv.submit_values_at("t", t.inds[:5].numpy()))
                time.sleep(0.001)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for th in threads:
            th.start()
        for swap_to in (tucker, cp, tucker):
            time.sleep(0.05)
            srv.publish("t", swap_to, DIMS)
        time.sleep(0.05)
        stop.set()
        for th in threads:
            th.join(timeout=30)
        srv.close()  # drain
        ref_a = cp.values_at(t.inds[:5]).numpy()
        ref_b = tucker.values_at(t.inds[:5]).numpy()
        assert len(futs) > 0
        for f in futs:
            got = f.result(timeout=10)  # zero drops
            assert (np.allclose(got, ref_a, rtol=1e-4, atol=1e-5)
                    or np.allclose(got, ref_b, rtol=1e-4, atol=1e-5))
        assert srv.registry.get("t").generation == 4


def test_server_emits_per_tenant_metrics(cps):
    """The same calls give the same metric names and counts as the
    reference's server."""
    jdec, dec = cps
    snaps = []
    for server_cls, scope, d, users in (
            (DecompServer, scoped_registry, dec, np.arange(2)),
            (jserve.DecompServer, jscoped_registry, jdec, jnp.arange(2))):
        with scope() as reg:
            with server_cls(buckets=(4,), max_wait_ms=0.5) as srv:
                srv.publish("acme", d)
                srv.values_at("acme", np.zeros((2, 3), np.int32))
                srv.top_k("acme", users, k=2)
            snaps.append(reg.snapshot())
    snap, jsnap = snaps
    assert snap["serve.acme.queries"]["value"] == 2.0
    assert snap["serve.acme.query_ms"]["count"] == 2
    assert 0.0 < snap["serve.batch_fill"]["mean"] <= 1.0
    assert snap["serve.registry.models"]["value"] == 1.0
    assert snap["serve.registry.resident_bytes"]["value"] \
        == resident_bytes(dec)
    assert snap["serve.qps"]["value"] > 0.0
    assert sorted(snap) == sorted(jsnap)
    for name in ("serve.acme.queries", "serve.registry.models",
                 "serve.registry.resident_bytes", "serve.queue.depth"):
        assert snap[name]["value"] == jsnap[name]["value"]
    for name in ("serve.acme.query_ms", "serve.batch_fill"):
        assert snap[name]["count"] == jsnap[name]["count"]


def test_server_from_config_and_session_integration():
    jt, t = lowrank()
    cfg = dict(method=dict(rank=4, niters=3),
               serve=dict(buckets=(8,), max_wait_ms=0.5, tenants=("a", "b"),
                          max_resident_mb=64.0))
    sess = Session(RunConfig(method=MethodConfig(**cfg["method"]),
                             serve=ServeConfig(**cfg["serve"])),
                   tensor=t, device="cpu")
    jsess = JSession.from_config(
        JRunConfig(method=JMethodConfig(**cfg["method"]),
                   serve=JServeConfig(**cfg["serve"])), tensor=jt)
    try:
        srv = sess.decomp_server()
        assert sess.decomp_server() is srv  # cached like other stages
        assert sorted(srv.tenants()) == ["a", "b"]
        got = srv.values_at("b", t.inds[:6].numpy())
        want = sess.serve_handle().query(t.inds[:6].numpy()).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert srv.stats()["batches_executed"] >= 1
        # the same tenants, dims, buckets and bytes as the reference's
        strip = lambda d: {t: {k: v for k, v in e.items() if k != "fit"}
                           for t, e in d.items()}
        assert strip(srv.tenants()) == strip(
            jsess.decomp_server().tenants())
    finally:
        sess.close()
        jsess.close()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit_values_at("a", np.zeros((1, 3), np.int32))


# ---------------------------------------------------------------------------
# ServeDaemon: the same HTTP surface as the reference's
# ---------------------------------------------------------------------------

def _http(url, data=None):
    try:
        with urllib.request.urlopen(url, data=data, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _same_json(got, want, path="body"):
    """Key for key; floats within the parity tolerance, the rest equal."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, \
        (path, got, want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, **TOL, err_msg=path)
    else:
        assert got == want, path


def test_daemon_http_endpoints(cps):
    """Both daemons over the same factors answer the same script with the
    same statuses and JSON bodies, key for key."""
    jdec, dec = cps
    t = lowrank()[1]
    script = [
        ("GET", "/healthz", None),
        ("GET", "/v1/tenants", None),
        ("GET", "/v1/top_k?tenant=web&user=1&k=3", None),
        ("POST", "/v1/values_at", {"tenant": "web",
                                   "coords": t.inds[:3].tolist()}),
        ("GET", "/v1/top_k?tenant=ghost&user=0&k=2", None),
        ("GET", "/v1/top_k?tenant=web&user=x", None),
        ("GET", "/nowhere", None),
        ("POST", "/v1/values_at", {"tenant": "web"}),
        ("GET", "/healthz", None),
    ]
    answers = []
    for server_cls, daemon_cls, scope, d in (
            (DecompServer, ServeDaemon, scoped_registry, dec),
            (jserve.DecompServer, jserve.ServeDaemon, jscoped_registry,
             jdec)):
        got = []
        with scope():
            with server_cls(buckets=(4,), max_wait_ms=0.5) as srv:
                srv.publish("web", d, DIMS)
                with daemon_cls(srv, port=0) as daemon:
                    for method, path, body in script:
                        data = None if method == "GET" else \
                            json.dumps(body).encode()
                        code, text = _http(daemon.url + path, data)
                        got.append((code, json.loads(text)))
                    code, prom = _http(daemon.url + "/metrics")
                    got.append((code, sorted(
                        line.split()[0] for line in prom.splitlines()
                        if line and not line.startswith("#"))))
                    code, text = _http(daemon.url + "/v1/shutdown", b"")
                    got.append((code, json.loads(text)))
                    assert daemon.shutdown_requested.wait(timeout=5)
        answers.append(got)
    port, ref = answers
    assert [c for c, _ in port] == [c for c, _ in ref]
    assert [c for c, _ in port] == [200, 200, 200, 200, 404, 400, 404, 404,
                                    200, 200, 200]
    for (_, p), (_, r) in zip(port[:4] + port[8:9] + port[10:],
                              ref[:4] + ref[8:9] + ref[10:]):
        _same_json(p, r)
    for (_, p), (_, r) in zip(port[4:8], ref[4:8]):
        assert sorted(p) == sorted(r) == ["error"]
    assert port[9][1] == ref[9][1]  # the /metrics series names
    assert any(name.startswith("serve_web_query_ms") for name in port[9][1])


def test_cli_serve_daemon_serves_until_its_duration(capsys):
    argv = ["serve-daemon", "--dataset", "yelp", "--scale", "0.0005",
            "--rank", "4", "--iters", "2", "--tenants", "a", "b",
            "--port", "0", "--duration-s", "0.3"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "# serving ['a', 'b'] at http://127.0.0.1:" in out
    assert "# shutdown: 0 batches executed, queue depth 0" in out
    from repro.api import cli as jcli

    def cfg_of(module, device):
        import argparse

        p = argparse.ArgumentParser()
        module._add_config_args(p)
        if device:
            p.add_argument("--device")
        p.add_argument("--duration-s", type=float)
        return module.config_from_args(p.parse_args(argv[1:]))

    assert cfg_of(cli, True).to_dict() == cfg_of(jcli, False).to_dict()
