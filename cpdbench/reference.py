"""Plain PyTorch CP-ALS and Tucker HOOI: the yardstick that decides
``correct``.

Written from the published algorithms (SPLATT's CP-ALS, the paper's
Algorithm 1; HOOI by thin SVDs of the chain-of-modes TTMc), straight from
the COO tensor and the initial factors, with no sorted layout, kernel or
cache.  It imports nothing of the program.

Two precisions:

* ``"float64"``, the judge: every step in float64.
* ``"tf32"``, the control: float32 storage and accumulation, with every
  operand of a multiplication first rounded to TF32 (10 mantissa bits), as
  tensor cores take float32 inputs.  It is the step below the float32 that
  the configurations state, and it has to come out as not correct.

The sparse products run in blocks of entries, so that the temporaries stay
near ``CHUNK_BYTES`` at any size.
"""
from __future__ import annotations

import math

import torch

CHUNK_BYTES = 1 << 30
# ridge on V's diagonal before the Cholesky factorisation, as in SPLATT
RIDGE = 1e-12


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 mantissa bits, to nearest, ties
    to even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


class Precision:
    """How the reference computes: its dtype and what it does to the
    operands of a multiplication."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def op(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return tf32(x) if self.name == "tf32" else x


def _blocks(nnz: int, width: int):
    step = max(1, CHUNK_BYTES // (8 * max(1, width)))
    for lo in range(0, nnz, step):
        yield lo, min(nnz, lo + step)


def _kron_rows(rows):
    """Row-wise Kronecker product, the first input the slowest axis."""
    out = rows[0]
    for r in rows[1:]:
        out = (out[:, :, None] * r[:, None, :]).reshape(out.shape[0], -1)
    return out


def mttkrp(inds, vals, factors, mode: int, p: Precision) -> torch.Tensor:
    """M[i, :] = sum over entries with i_mode == i of x * the Hadamard
    product of the other modes' factor rows."""
    rank = factors[0].shape[1]
    out = torch.zeros((factors[mode].shape[0], rank), dtype=p.dtype,
                      device=vals.device)
    for lo, hi in _blocks(vals.shape[0], rank):
        rows = p.op(vals[lo:hi])[:, None]
        for m, a in enumerate(factors):
            if m != mode:
                rows = p.op(rows) * p.op(a[inds[lo:hi, m].long()])
        out.index_add_(0, inds[lo:hi, mode].long(), rows)
    return out


def ttmc(inds, vals, factors, mode: int, p: Precision) -> torch.Tensor:
    """Y[i, :] = sum over entries with i_mode == i of x * the Kronecker
    product of the other modes' factor rows (ascending modes, row-major)."""
    others = [m for m in range(len(factors)) if m != mode]
    width = math.prod(factors[m].shape[1] for m in others)
    out = torch.zeros((factors[mode].shape[0], width), dtype=p.dtype,
                      device=vals.device)
    for lo, hi in _blocks(vals.shape[0], width):
        rows = [p.op(factors[m][inds[lo:hi, m].long()]) for m in others]
        rows[0] = p.op(p.op(vals[lo:hi])[:, None] * rows[0])
        for i in range(1, len(rows)):
            rows[i] = p.op(rows[i])
        out.index_add_(0, inds[lo:hi, mode].long(), _kron_rows(rows))
    return out


def _gram(a, p):
    return p.op(a).T @ p.op(a)


def _hadamard(mats, skip, p):
    out = None
    for m, g in enumerate(mats):
        if m != skip:
            out = g if out is None else p.op(out) * p.op(g)
    return out


# ---------------------------------------------------------------------------
# CP-ALS
# ---------------------------------------------------------------------------

def cp_als(inds, vals, init, mix: dict, p: Precision,
           states: list | None = None) -> dict:
    """SPLATT's CP-ALS from ``init``: per mode, V = the Hadamard product of
    the other Grams, A = MTTKRP V^-1 (Cholesky), columns normalised by
    their max (first iteration, at least 1) or 2-norm; the fit on the last
    mode from the Gram matrices and the last MTTKRP.  Stops after
    ``niters``, or when the fit moves less than ``tol`` > 0.  The factors
    at the end of each iteration are appended to ``states``, if given."""
    niters, tol = int(mix["niters"]), float(mix["tol"])
    factors = [a.to(p.dtype) for a in init]
    x = vals.to(p.dtype)
    norm_x_sq = torch.sum(p.op(x) * p.op(x))
    grams = [_gram(a, p) for a in factors]
    rank = factors[0].shape[1]
    eye = torch.eye(rank, dtype=p.dtype, device=x.device)
    lmbda = torch.ones(rank, dtype=p.dtype, device=x.device)
    fit, fit_prev = 0.0, 0.0
    for it in range(niters):
        for n in range(len(factors)):
            v = _hadamard(grams, n, p)
            m_mat = mttkrp(inds, x, factors, n, p)
            v_inv = torch.cholesky_solve(
                eye, torch.linalg.cholesky(v + RIDGE * eye))
            a = p.op(m_mat) @ p.op(v_inv)
            if it == 0:
                lmbda = torch.clamp(torch.amax(torch.abs(a), dim=0), min=1.0)
            else:
                lmbda = torch.sqrt(torch.sum(p.op(a) * p.op(a), dim=0))
            a = a / torch.where(lmbda == 0, torch.ones_like(lmbda), lmbda)
            factors[n] = a
            grams[n] = _gram(a, p)
        if states is not None:
            states.append(tuple(factors))
        norm_z_sq = torch.sum(p.op(p.op(lmbda[:, None] * lmbda[None, :])
                                   * p.op(_hadamard(grams, -1, p))))
        inner = torch.sum(p.op(torch.sum(p.op(m_mat) * p.op(a), dim=0))
                          * p.op(lmbda))
        resid = torch.clamp(norm_x_sq + norm_z_sq - 2.0 * inner, min=0.0)
        fit = float(1.0 - torch.sqrt(resid) / torch.sqrt(norm_x_sq))
        delta, fit_prev = fit - fit_prev, fit
        if tol > 0.0 and it > 0 and abs(delta) < tol:
            break
    return {"fit": fit, "lmbda": lmbda, "factors": tuple(factors)}


def cp_model_fit(inds, vals, out: dict) -> float:
    """1 - ||X - X_hat|| / ||X|| of a CP model ``lmbda``, ``factors``, in
    float64, with <X, X_hat> summed over the stored entries."""
    x = vals.double()
    lmbda = out["lmbda"].double()
    factors = [a.double() for a in out["factors"]]
    inner = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo, hi in _blocks(x.shape[0], lmbda.shape[0]):
        rows = lmbda[None, :].expand(hi - lo, -1)
        for m, a in enumerate(factors):
            rows = rows * a[inds[lo:hi, m].long()]
        inner += torch.sum(x[lo:hi] * rows.sum(dim=1))
    had = _hadamard([a.T @ a for a in factors], -1, Precision("float64"))
    norm_z_sq = torch.sum(lmbda[:, None] * lmbda[None, :] * had)
    norm_x_sq = torch.sum(x * x)
    resid = torch.clamp(norm_x_sq + norm_z_sq - 2.0 * inner, min=0.0)
    return float(1.0 - torch.sqrt(resid) / torch.sqrt(norm_x_sq))


# ---------------------------------------------------------------------------
# Tucker HOOI
# ---------------------------------------------------------------------------

def _core_from_last(u_last, y_last, ranks, p):
    order = len(ranks)
    core = (p.op(u_last).T @ p.op(y_last)).reshape(
        (ranks[-1],) + tuple(ranks[:-1]))
    return torch.movedim(core, 0, order - 1)


def tucker_hooi(inds, vals, init, mix: dict, p: Precision,
                states: list | None = None) -> dict:
    """HOOI from ``init``: per mode, U_n = the leading R_n left singular
    vectors of the mode's TTMc against the other factors; the core
    G = U_last^T Y_last; fit = 1 - sqrt(||X||^2 - ||G||^2) / ||X||.  Stops
    after ``niters``, or when the fit moves less than ``tol`` > 0.  The
    factors at the end of each sweep are appended to ``states``, if
    given."""
    niters, tol = int(mix["niters"]), float(mix["tol"])
    factors = [a.to(p.dtype) for a in init]
    ranks = [a.shape[1] for a in factors]
    x = vals.to(p.dtype)
    norm_x_sq = torch.sum(p.op(x) * p.op(x))
    fit, fit_prev, core = 0.0, 0.0, None
    for it in range(niters):
        for n in range(len(factors)):
            y = ttmc(inds, x, factors, n, p)
            factors[n] = torch.linalg.svd(
                p.op(y), full_matrices=False)[0][:, :ranks[n]].contiguous()
        if states is not None:
            states.append(tuple(factors))
        core = _core_from_last(factors[-1], y, ranks, p)
        resid = torch.clamp(norm_x_sq - torch.sum(p.op(core) * p.op(core)),
                            min=0.0)
        fit = float(1.0 - torch.sqrt(resid) / torch.sqrt(norm_x_sq))
        delta, fit_prev = fit - fit_prev, fit
        if tol > 0.0 and it > 0 and abs(delta) < tol:
            break
    return {"fit": fit, "core": core, "factors": tuple(factors)}


def subspace_gap(got, want) -> float:
    """Largest over modes of ||U U^T - V V^T||_F / sqrt(2 R): 0 for the
    same column spaces, 1 for orthogonal ones.  Signs and rotations within
    a space do not count."""
    worst = 0.0
    for u, v in zip(got, want):
        u, v = u.double(), v.double()
        cross = torch.sum((u.T @ v) ** 2)
        sq = (torch.sum((u.T @ u) ** 2) + torch.sum((v.T @ v) ** 2)
              - 2.0 * cross)
        worst = max(worst, math.sqrt(max(float(sq), 0.0)
                                     / (2.0 * u.shape[1])))
    return worst


def _truncation_gap(u, y) -> float:
    """The share of the best rank-R energy of ``y`` (R = ``u``'s columns)
    that the span of ``u`` misses: 0 for the leading singular subspace,
    second-order in its rounding however nearly equal the singular values
    at the cut are."""
    q = torch.linalg.qr(u)[0]
    captured = float(torch.sum((q.T @ y) ** 2))
    eig = torch.linalg.eigvalsh(y.T @ y)
    best = float(torch.sum(eig[-u.shape[1]:]))
    return abs(best - captured) / best


def tucker_steps(inds, vals, init, states, core) -> dict:
    """Every step of a HOOI run judged in float64 from the run's own
    states: the factors it began from (``init``) and those it held at the
    end of each sweep (``states``, the last the answer's), ``core`` its
    core.  For each sweep and mode, Y is the mode's TTMc against the
    factors the step was given (the earlier modes' of this sweep, the later
    modes' of the last), worked out again from the tensor; the step's U
    has to span Y's leading subspace.  Returns ``truncation_gap``, the
    worst step's :func:`_truncation_gap`, with the sweep and mode it came
    from, and ``core_gap``, the core against U_last^T Y of the last step
    (relative, Frobenius)."""
    x = vals.double()
    f64 = Precision("float64")
    prev = [a.double() for a in init]
    order = len(prev)
    worst, where, y = 0.0, None, None
    for sweep, state in enumerate(states):
        cur = [a.double() for a in state]
        for n in range(order):
            y = ttmc(inds, x, cur[:n + 1] + prev[n + 1:], n, f64)
            gap = _truncation_gap(cur[n], y)
            if not gap <= worst:
                worst, where = gap, [sweep, n]
        prev = cur
    ranks = [a.shape[1] for a in prev]
    want = _core_from_last(prev[-1], y, ranks, f64)
    core_gap = float(torch.linalg.norm(core.double() - want)
                     / torch.linalg.norm(want))
    return {"truncation_gap": worst, "worst_step": where,
            "core_gap": core_gap}


def _energy(fit: float) -> float:
    """The share of ||X||^2 that a model of this fit captures,
    1 - (1 - fit)^2: the number a fit near 0 is read by."""
    return 1.0 - (1.0 - fit) ** 2


def judge_cp(inds, vals, init, mix: dict, got: dict, wanted=None,
             cache: dict | None = None) -> dict:
    """The numbers a CP cell may compare for one fit ``got`` (``fit``,
    ``lmbda``, ``factors``), against the judge's run from the same
    ``init`` (kept in ``cache`` for another answer from the same start):

    * ``fit_gap``: the reported fit against the judge's;
    * ``model_gap``: the reported fit against the returned model's own
      fit, recomputed in float64;
    * ``energy_gap``: the share of ||X||^2 the returned model captures
      against the judge's, relative (for fits near 0);
    * ``subspace_gap``: the factors against the judge's
      (:func:`subspace_gap`).

    Only those in ``wanted`` (all when None) are worked out."""
    names = ("fit_gap", "model_gap", "energy_gap", "subspace_gap")
    wanted = set(names if wanted is None else wanted)
    cache = {} if cache is None else cache
    if "want" not in cache:
        cache["want"] = cp_als(inds, vals, init, mix, Precision("float64"))
    want = cache["want"]
    out = {"fit": got["fit"], "judge_fit": want["fit"]}
    if wanted & {"model_gap", "energy_gap"}:
        out["model_fit"] = cp_model_fit(inds, vals, got)
    if "fit_gap" in wanted:
        out["fit_gap"] = abs(got["fit"] - want["fit"])
    if "model_gap" in wanted:
        out["model_gap"] = abs(got["fit"] - out["model_fit"])
    if "energy_gap" in wanted:
        out["energy_gap"] = (abs(_energy(out["model_fit"])
                                 - _energy(want["fit"]))
                             / max(_energy(want["fit"]), 1e-300))
    if "subspace_gap" in wanted:
        out["subspace_gap"] = subspace_gap(got["factors"], want["factors"])
    return out


def judge_tucker(inds, vals, init, mix: dict, got: dict, wanted=None,
                 cache: dict | None = None) -> dict:
    """The numbers a Tucker cell may compare for one fit ``got`` (``core``,
    ``factors``, ``states``): :func:`tucker_steps`, every sweep of the run
    judged from its own states; the truncation gap reads infinite where the
    run made another number of sweeps than the mix asks, or its answer is
    not its last state."""
    states = list(got["states"])
    out = tucker_steps(inds, vals, init, states, got["core"])
    last_is_answer = bool(states) and all(
        torch.equal(a, b) for a, b in zip(states[-1], got["factors"]))
    if len(states) != int(mix["niters"]) or not last_is_answer:
        out["truncation_gap"] = math.inf
    out["sweeps"] = len(states)
    return out


# the methods a traffic mix may name: the reference run, the parts of the
# program's answer that are judged, whether the judge reads the run's
# state at the end of each sweep, and the judge
METHODS = {
    "cp_als": {"run": cp_als, "fields": ("lmbda", "factors"),
               "states": False, "judge": judge_cp},
    "tucker_hooi": {"run": tucker_hooi, "fields": ("core", "factors"),
                    "states": True, "judge": judge_tucker},
}
