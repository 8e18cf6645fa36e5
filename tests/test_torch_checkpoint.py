"""The port's checkpoint manager against the JAX package's.

The first part mirrors cases 1-5, 7 and 8 of ``tests/test_checkpoint.py``
on the port alone (the training loop and the optimizers are not ported):
round trip, atomic rename, incomplete steps skipped, keep-k, async saves,
and a method's state saved at iteration 4 resuming bit for bit against the
port's own uninterrupted run (the CPU paths are deterministic).  The second
passes checkpoints between the packages: the key strings are read from a
checkpoint the reference writes, and a reference checkpoint resumes in the
port within the parity tolerances (fit 1e-4, factors 1e-2) of the port's
uninterrupted run.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.methods import fit as jax_fit
from repro.methods import make_state as jax_make_state
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.checkpoint.manager import flatten
from repro_torch.core.cpals import CPALSState
from repro_torch.methods import DecompState, fit, get_method, make_state

from test_torch_helpers import both_tensors, np_factors, planted

SEED = 0
METHODS = ["cp_als", "cp_nn_hals", "tucker_hooi", "cp_als_streaming"]


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": (torch.zeros((2, 2)), torch.full((3,), 2.5))}}


def leaves(t):
    return flatten(t)[1]


def test_roundtrip(tmp_path):
    t = tree()
    save_pytree(tmp_path / "ck", t, extra={"step": 7})
    restored, extra = load_pytree(tmp_path / "ck", like=t)
    assert extra["step"] == 7
    assert flatten(restored)[0] == ["a", "b/c", "b/d/0", "b/d/1"]
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert isinstance(restored["b"]["d"], tuple)


def test_atomic_rename_never_leaves_partial(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, tree())
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "garbage").write_text("x")
    assert mgr.latest_step() == 1
    _, extra = mgr.restore(tree())
    assert extra["step"] == 1


def test_incomplete_checkpoint_is_skipped(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, tree())
    mgr.save(2, tree())
    meta = tmp_path / "step_00000002" / "meta.json"
    m = json.loads(meta.read_text())
    m["complete"] = False
    meta.write_text(json.dumps(m))
    assert mgr.latest_step() == 1
    with pytest.raises(IOError, match="incomplete"):
        load_pytree(tmp_path / "step_00000002", like=tree())


def test_keep_k_garbage_collection(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, tree())
    assert mgr.steps() == [4, 5]
    assert mgr.read_extra(5) == {"step": 5}


def test_async_save_then_restore(tmp_path):
    """The async save snapshots the leaves before its thread starts: an
    in-place update after ``save`` returns does not reach the file."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    t = tree()
    mgr.save(3, t)
    t["a"].add_(100.0)
    mgr.wait()
    restored, extra = mgr.restore(t)
    assert extra["step"] == 3
    torch.testing.assert_close(restored["a"],
                               torch.arange(12.0).reshape(3, 4))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(t)


def lowrank_tensor():
    inds, vals = planted((10, 9, 8), 3, 0)
    return both_tensors(inds, vals, (10, 9, 8))


def _kw(method):
    return {"n_chunks": 3} if get_method(method).supports_streaming else {}


@pytest.mark.parametrize("method", METHODS)
def test_decomp_state_roundtrip_resumes_bit_exactly(tmp_path, method):
    """A DecompState saved through the manager at iteration 4 resumes to
    the uninterrupted run's factors and fit, bit for bit."""
    _, t = lowrank_tensor()
    rank = (3, 3, 3) if method == "tucker_hooi" else 4
    states = []
    full = fit(t, rank, method=method, niters=8, generator=SEED,
               checkpoint_cb=states.append, **_kw(method))
    mid = states[3]
    assert isinstance(mid, DecompState) and int(mid.iteration) == 4

    mgr = CheckpointManager(tmp_path / method, async_save=False)
    mgr.save(int(mid.iteration), mid)
    restored, extra = mgr.restore(mid)
    assert extra["step"] == 4 and isinstance(restored, DecompState)

    resumed = fit(t, rank, method=method, niters=8, generator=SEED,
                  state=restored, **_kw(method))
    for a, b in zip(full.factors, resumed.factors):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(full.fit) == float(resumed.fit)


def test_cpals_state_roundtrip_through_manager(tmp_path):
    from repro_torch.methods import cp_als

    _, t = lowrank_tensor()
    states = []
    full = cp_als(t, rank=4, niters=6, generator=SEED,
                  checkpoint_cb=states.append)
    mid = states[2]
    assert isinstance(mid, CPALSState)
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(int(mid.iteration), mid)
    restored, _ = mgr.restore(mid)
    assert isinstance(restored, CPALSState)
    resumed = cp_als(t, rank=4, niters=6, generator=SEED, state=restored)
    for a, b in zip(full.factors, resumed.factors):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _jax_state(method, rank):
    jt, _ = lowrank_tensor()
    jstates = []
    kw = _kw(method)
    if method == "tucker_hooi":
        init = [np.linalg.qr(np.random.default_rng(1).standard_normal(
            (d, r)))[0].astype(np.float32) for d, r in zip(jt.dims, rank)]
        aux = {}
    else:
        init = np_factors(jt.dims, rank, 1)
        aux = ({"lmbda": jnp.ones(rank)}
               if get_method(method).state_aux else {})
    zero = jnp.asarray(np.float32(0.0))
    state0 = jax_make_state([jnp.asarray(a) for a in init], aux, zero, zero,
                            0)
    jax_fit(jt, rank, method=method, niters=4, state=state0,
            checkpoint_cb=jstates.append, **kw)
    return init, jstates[-1]


@pytest.mark.parametrize("method", METHODS)
def test_checkpoint_keys_match_reference(tmp_path, method):
    """The port flattens a state to the leaves and key strings the
    reference's checkpoint holds (read back from its meta.json)."""
    rank = (3, 3, 3) if method == "tucker_hooi" else 4
    _, jmid = _jax_state(method, rank)
    JaxCheckpointManager(tmp_path, async_save=False).save(4, jmid)
    meta = json.loads((tmp_path / "step_00000004" / "meta.json").read_text())
    pmid = make_state([torch.zeros(1)] * 3,
                      {k: torch.zeros(1)
                       for k in get_method(method).state_aux},
                      torch.tensor(0.0), torch.tensor(0.0), 4)
    keys, _ = flatten(pmid)
    assert keys == meta["keys"]
    want = ["0/0", "0/1", "0/2"] + (
        ["1/lmbda"] if get_method(method).state_aux else []) + ["2", "3",
                                                                "4"]
    assert keys == want


def test_cpals_state_keys_match_reference(tmp_path):
    from repro.core.cpals import CPALSState as JaxCPALSState

    one = jnp.ones(2)
    JaxCheckpointManager(tmp_path, async_save=False).save(
        1, JaxCPALSState((one,) * 3, one, one[0], one[0],
                         jnp.array(1, jnp.int32)))
    meta = json.loads((tmp_path / "step_00000001" / "meta.json").read_text())
    one = torch.ones(2)
    keys, _ = flatten(CPALSState((one,) * 3, one, one[0], one[0],
                                 torch.tensor(1, dtype=torch.int32)))
    assert keys == meta["keys"] == ["0/0", "0/1", "0/2", "1", "2", "3", "4"]


@pytest.mark.parametrize("method", METHODS)
def test_reference_checkpoint_resumes_in_port(tmp_path, method):
    """A reference checkpoint at iteration 4 restores into the port's state
    structure and resumes to within the parity tolerances of the port's
    uninterrupted run from the same initial factors."""
    _, t = lowrank_tensor()
    # Tucker below the planted rank 3: at the full rank the residual is
    # float32 noise and the fit 1 - sqrt(noise) moves by 1e-4 between any
    # two summation orders
    rank = (2, 3, 2) if method == "tucker_hooi" else 4
    init, jmid = _jax_state(method, rank)
    JaxCheckpointManager(tmp_path, async_save=False).save(4, jmid)

    aux = get_method(method).state_aux
    zero = torch.tensor(0.0)
    state0 = make_state([torch.from_numpy(a) for a in init],
                        {k: torch.ones(rank) for k in aux}, zero, zero, 0)
    full = fit(t, rank, method=method, niters=8, state=state0,
               **_kw(method))
    restored, extra = CheckpointManager(tmp_path).restore(state0)
    assert extra["step"] == 4 and int(restored.iteration) == 4
    assert all(isinstance(a, torch.Tensor) for a in restored.factors)
    resumed = fit(t, rank, method=method, niters=8, state=restored,
                  **_kw(method))
    assert abs(float(resumed.fit) - float(full.fit)) < 1e-4
    for a, b in zip(resumed.factors, full.factors):
        if method == "tucker_hooi":
            torch.testing.assert_close(a @ a.T, b @ b.T, rtol=0, atol=1e-4)
        else:
            torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-2)


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The reverse: the reference restores the port's checkpoint of a
    DecompState into its own structure, array for array."""
    _, t = lowrank_tensor()
    states = []
    fit(t, 4, method="cp_als", niters=3, generator=SEED,
        checkpoint_cb=states.append)
    CheckpointManager(tmp_path, async_save=False).save(3, states[-1])
    _, jmid = _jax_state("cp_als", 4)
    restored, extra = JaxCheckpointManager(tmp_path).restore(jmid)
    assert extra["step"] == 3 and int(restored.iteration) == 3
    for a, b in zip(restored.factors, states[-1].factors):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(restored.aux["lmbda"]),
                                  states[-1].aux["lmbda"].numpy())
    keys, arrays, _ = jax_load_pytree(tmp_path / "step_00000003")
    assert keys == flatten(states[-1])[0]
    assert arrays[-1].dtype == np.int32 and arrays[-1].shape == ()
