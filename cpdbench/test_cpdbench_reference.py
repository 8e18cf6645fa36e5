"""The plain reference against hand-worked cases: the sparse products, the
TF32 rounding of the control, CP-ALS and HOOI on tensors whose answer is
known, and the fit of a model recomputed from its parts."""
import itertools
import math

import numpy as np
import pytest
import torch

from cpdbench import reference

F64 = reference.Precision("float64")
TF32 = reference.Precision("tf32")


def full_tensor(dense: np.ndarray):
    """Every cell of a dense array as a stored entry."""
    idx = np.array(list(itertools.product(*[range(d) for d in dense.shape])))
    vals = dense[tuple(idx.T)]
    return (torch.tensor(idx, dtype=torch.int32),
            torch.tensor(vals, dtype=torch.float64))


def test_mttkrp_by_hand():
    inds = torch.tensor([[0, 1, 0], [1, 0, 1], [0, 0, 1]], dtype=torch.int32)
    vals = torch.tensor([2.0, 3.0, 5.0], dtype=torch.float64)
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.float64)
    b = torch.tensor([[1.0, -1.0], [2.0, 0.5]], dtype=torch.float64)
    c = torch.tensor([[0.5, 1.0], [2.0, 3.0]], dtype=torch.float64)
    got = reference.mttkrp(inds, vals, (a, b, c), 0, F64)
    # row 0: 2 * b[1] * c[0] + 5 * b[0] * c[1]; row 1: 3 * b[0] * c[1]
    want = torch.tensor([[2 * 2 * 0.5 + 5 * 1 * 2, 2 * 0.5 * 1 + 5 * -1 * 3],
                         [3 * 1 * 2, 3 * -1 * 3]], dtype=torch.float64)
    assert torch.equal(got, want)


def test_ttmc_column_order():
    inds = torch.tensor([[1, 0, 1]], dtype=torch.int32)
    vals = torch.tensor([2.0], dtype=torch.float64)
    a = torch.zeros((2, 1), dtype=torch.float64)
    b = torch.tensor([[1.0, 10.0]], dtype=torch.float64)
    c = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]], dtype=torch.float64)
    got = reference.ttmc(inds, vals, (a, b, c), 0, F64)
    # ascending other modes, row-major: column r_b * 3 + r_c
    assert got[0].tolist() == [0.0] * 6
    assert got[1].tolist() == [2.0, 4.0, 6.0, 20.0, 40.0, 60.0]


def test_tf32_rounding():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + 1.5 * ulp, 1.0 + 0.4 * ulp,
                      -(1.0 + 0.6 * ulp), 3.0], dtype=torch.float32)
    got = reference.tf32(x).tolist()
    # ties go to the even neighbour
    assert got == [1.0, 1.0, 1.0 + 2 * ulp, 1.0, -(1.0 + ulp), 3.0]
    y = torch.rand(1000, dtype=torch.float32,
                   generator=torch.Generator().manual_seed(2)) + 0.5
    rel = torch.abs(reference.tf32(y) - y) / y
    assert float(rel.max()) <= 2.0 ** -11
    assert float(rel.max()) > 2.0 ** -13


def test_cp_als_recovers_a_rank_one_tensor():
    rng = np.random.default_rng(0)
    u, v, w = (rng.uniform(0.5, 1.5, n) for n in (4, 5, 6))
    inds, vals = full_tensor(np.einsum("i,j,k->ijk", u, v, w))
    init = tuple(torch.tensor(rng.uniform(0, 1, (n, 1))) for n in (4, 5, 6))
    out = reference.cp_als(inds, vals, init, {"niters": 5, "tol": 0.0}, F64)
    # the fit's formula cancels ||X||^2 against ||X_hat||^2: its residual
    # is the square root of float64's rounding
    assert out["fit"] == pytest.approx(1.0, abs=1e-7)
    model = out["lmbda"] * torch.einsum(
        "ir,jr,kr->ijk", *out["factors"]).squeeze()
    assert torch.allclose(model.reshape(-1), vals, rtol=1e-9)
    assert reference.cp_model_fit(inds, vals, out) == pytest.approx(
        1.0, abs=1e-7)


def test_cp_als_first_update_by_hand():
    rng = np.random.default_rng(1)
    dense = rng.uniform(0, 1, (3, 4, 5))
    inds, vals = full_tensor(dense)
    init = [rng.uniform(0, 1, (n, 2)) for n in (3, 4, 5)]
    out = reference.cp_als(inds, vals, tuple(map(torch.tensor, init)),
                           {"niters": 1, "tol": 0.0}, F64)
    a, b, c = init
    # mode 0 by the normal equations, normalised by the column max (>= 1)
    m0 = np.einsum("ijk,jr,kr->ir", dense, b, c)
    a = m0 @ np.linalg.inv((b.T @ b) * (c.T @ c))
    a = a / np.maximum(np.abs(a).max(0), 1.0)
    m1 = np.einsum("ijk,ir,kr->jr", dense, a, c)
    b = m1 @ np.linalg.inv((a.T @ a) * (c.T @ c))
    b = b / np.maximum(np.abs(b).max(0), 1.0)
    m2 = np.einsum("ijk,ir,jr->kr", dense, a, b)
    c = m2 @ np.linalg.inv((a.T @ a) * (b.T @ b))
    lam = np.maximum(np.abs(c).max(0), 1.0)
    c = c / lam
    for got, want in zip(out["factors"], (a, b, c)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)
    np.testing.assert_allclose(out["lmbda"].numpy(), lam, rtol=1e-8)
    x_hat = np.einsum("r,ir,jr,kr->ijk", lam, a, b, c)
    fit = 1 - np.linalg.norm(dense - x_hat) / np.linalg.norm(dense)
    assert out["fit"] == pytest.approx(fit, abs=1e-10)
    assert reference.cp_model_fit(inds, vals, out) == pytest.approx(
        fit, abs=1e-10)


def test_hooi_recovers_a_multilinear_rank_tensor():
    rng = np.random.default_rng(2)
    core = rng.normal(size=(2, 3, 2))
    us = [np.linalg.qr(rng.normal(size=(n, r)))[0]
          for n, r in zip((5, 6, 7), (2, 3, 2))]
    dense = np.einsum("pqr,ip,jq,kr->ijk", core, *us)
    inds, vals = full_tensor(dense)
    init = tuple(torch.tensor(np.linalg.qr(rng.normal(size=(n, r)))[0])
                 for n, r in zip((5, 6, 7), (2, 3, 2)))
    states = []
    out = reference.tucker_hooi(inds, vals, init,
                                {"niters": 3, "tol": 0.0}, F64, states)
    assert out["fit"] == pytest.approx(1.0, abs=1e-6)
    assert reference.subspace_gap(out["factors"],
                                  [torch.tensor(u) for u in us]) < 1e-6
    assert len(states) == 3 and states[-1] == out["factors"]
    steps = reference.tucker_steps(inds, vals, init, states, out["core"])
    assert steps["truncation_gap"] < 1e-12 and steps["core_gap"] < 1e-12
    x_hat = torch.einsum("pqr,ip,jq,kr->ijk", out["core"], *out["factors"])
    assert torch.allclose(x_hat.reshape(-1), vals, atol=1e-10)


def test_model_fits_match_the_runs_fit():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, [20, 15, 25], size=(400, 3))
    idx = np.unique(idx, axis=0)
    inds = torch.tensor(idx, dtype=torch.int32)
    vals = torch.tensor(rng.uniform(0.1, 1, idx.shape[0]))
    g = torch.Generator().manual_seed(3)
    cp_init = tuple(torch.rand(n, 4, dtype=torch.float64, generator=g)
                    for n in (20, 15, 25))
    out = reference.cp_als(inds, vals, cp_init, {"niters": 4, "tol": 0.0},
                           F64)
    assert reference.cp_model_fit(inds, vals, out) == pytest.approx(
        out["fit"], abs=1e-10)
    t_init = tuple(torch.linalg.qr(torch.randn(n, 3, dtype=torch.float64,
                                               generator=g))[0]
                   for n in (20, 15, 25))
    states = []
    out = reference.tucker_hooi(inds, vals, t_init,
                                {"niters": 2, "tol": 0.0}, F64, states)
    # the fit from the core is the model's fit: the factors are orthonormal
    # and the core is their projection of X
    core, fac = out["core"], out["factors"]
    x_hat = torch.einsum("pqr,ip,jq,kr->ijk", core, *fac)
    dense = torch.zeros(20, 15, 25, dtype=torch.float64)
    dense[tuple(inds.long().T)] = vals
    fit = 1 - float(torch.linalg.norm(dense - x_hat) / torch.linalg.norm(dense))
    assert out["fit"] == pytest.approx(fit, abs=1e-10)
    steps = reference.tucker_steps(inds, vals, t_init, states, core)
    assert steps["truncation_gap"] < 1e-12 and steps["core_gap"] < 1e-12
    ctl_states = []
    ctl = reference.tucker_hooi(inds, vals, t_init,
                                {"niters": 2, "tol": 0.0}, TF32, ctl_states)
    assert ctl["core"].dtype == torch.float32
    assert abs(ctl["fit"] - out["fit"]) < 1e-2
    ctl_steps = reference.tucker_steps(inds, vals, t_init, ctl_states,
                                       ctl["core"])
    assert ctl_steps["truncation_gap"] > 1e3 * steps["truncation_gap"]


def test_tucker_steps_see_a_first_mode_step():
    """A sweep whose first mode kept its factor reads as a wrong step,
    though the last mode's step, and so the core, are sound."""
    rng = np.random.default_rng(8)
    idx = np.unique(rng.integers(0, [20, 15, 25], size=(600, 3)), axis=0)
    inds = torch.tensor(idx, dtype=torch.int32)
    vals = torch.tensor(rng.uniform(0.1, 1, idx.shape[0]))
    g = torch.Generator().manual_seed(8)
    init = tuple(torch.linalg.qr(torch.randn(n, 3, dtype=torch.float64,
                                             generator=g))[0]
                 for n in (20, 15, 25))
    mix = {"niters": 2, "tol": 0.0}
    states = []
    out = reference.tucker_hooi(inds, vals, init, mix, F64, states)
    sound = reference.judge_tucker(inds, vals, init, mix,
                                   dict(out, states=states))
    assert sound["truncation_gap"] < 1e-12 and sound["sweeps"] == 2
    # sweep 2 with mode 0 left as sweep 1 had it, modes 1 and 2 redone
    x = vals
    f = list(states[0])
    for n in (1, 2):
        y = reference.ttmc(inds, x, f, n, F64)
        f[n] = torch.linalg.svd(y, full_matrices=False)[0][:, :3]
    core = (f[2].T @ y).reshape(3, 3, 3).movedim(0, 2)
    bad = [states[0], tuple(f)]
    got = reference.judge_tucker(inds, vals, init, mix,
                                 {"core": core, "factors": tuple(f),
                                  "states": bad})
    assert got["core_gap"] < 1e-12
    assert got["truncation_gap"] > 1e-6 and got["worst_step"] == [1, 0]
    # a sweep too few, or an answer that is not the last state
    short = reference.judge_tucker(inds, vals, init, mix,
                                   dict(out, states=states[:1]))
    assert short["truncation_gap"] == math.inf
    other = reference.judge_tucker(inds, vals, init, mix,
                                   dict(out, states=[states[0], states[0]]))
    assert other["truncation_gap"] == math.inf


def test_subspace_gap():
    g = torch.Generator().manual_seed(5)
    q = torch.linalg.qr(torch.randn(10, 4, dtype=torch.float64,
                                    generator=g))[0]
    rot = torch.linalg.qr(torch.randn(4, 4, dtype=torch.float64,
                                      generator=g))[0]
    # the gap is the square root of a difference of squares, so float64's
    # rounding leaves about 1e-8 for equal spaces
    assert reference.subspace_gap([q], [q @ rot]) < 1e-7
    e = torch.eye(10, dtype=torch.float64)
    assert reference.subspace_gap([e[:, :2]], [e[:, 2:4]]) == \
        pytest.approx(1.0)
    assert math.isclose(reference.subspace_gap([e[:, :2]], [e[:, 1:3]]),
                        math.sqrt(2 / 4))


def test_blocks_cover_every_entry(monkeypatch):
    monkeypatch.setattr(reference, "CHUNK_BYTES", 8 * 3 * 7)
    rng = np.random.default_rng(4)
    inds = torch.tensor(rng.integers(0, 6, size=(50, 3)), dtype=torch.int32)
    vals = torch.tensor(rng.uniform(size=50))
    g = torch.Generator().manual_seed(6)
    fac = tuple(torch.rand(6, 3, dtype=torch.float64, generator=g)
                for _ in range(3))
    small = reference.mttkrp(inds, vals, fac, 2, F64)
    monkeypatch.setattr(reference, "CHUNK_BYTES", 1 << 30)
    assert torch.allclose(small, reference.mttkrp(inds, vals, fac, 2, F64))
