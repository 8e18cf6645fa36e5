"""The kernels' work counts: taken from the COO tensor and the dense
operands, so that K1 over a CSF and K3 over the linearized workspace of
the same tensor are read against the same least time, though their stored
bytes differ."""
import pytest
import torch

from cpdbench import generate, plugins, readers

MTTKRP = plugins.module("counts", "mttkrp")
TTMC = plugins.module("counts", "ttmc")
PEAK = plugins.peak_for("NVIDIA H100 80GB HBM3")


def test_mttkrp_by_hand():
    # 10 entries of a (4, 5, 6) tensor, rank 2, mode 1: 10 * 16 bytes of
    # entries, factors of modes 0 and 2 (4*2 + 6*2 words), output 5*2 words
    nbytes, ops = MTTKRP.call((4, 5, 6), 10, (2, 2, 2), 1)
    assert nbytes == 160 + 4 * (8 + 12) + 4 * 10
    assert ops == 10 * 2 * 3


def test_ttmc_by_hand():
    # ranks (2, 3, 4), mode 0: W = 12; per entry 3 (value times the first
    # row) + 12 (Kronecker row) + 12 (the add)
    nbytes, ops = TTMC.call((4, 5, 6), 10, (2, 3, 4), 0)
    assert ops == 10 * (3 + 12 + 12)
    assert nbytes == 160 + 4 * (5 * 3 + 6 * 4) + 4 * 4 * 12


def test_yelp_sizes():
    dims, nnz = (41_000, 11_000, 75_000), 7_998_632
    nbytes, _ = MTTKRP.call(dims, nnz, (35,) * 3, 0)
    assert 140e6 < nbytes < 150e6
    _, ops = TTMC.call(dims, nnz, (16,) * 3, 2)
    assert abs(ops - 4.22e9) < 0.01e9
    least = readers.least_s(PEAK, *TTMC.call(dims, nnz, (16,) * 3, 2))
    assert least == pytest.approx(ops / 67e12)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_csf_and_linearized_read_the_same_work(mode):
    from repro_torch.core.coo import SparseTensor
    from repro_torch.core.csf import build_csf
    from repro_torch.core.linearized import build_linearized

    cfg = {"dims": [50, 30, 70], "nnz": 6000, "skew": 1.5,
           "dtype": "float32"}
    inds, vals = generate.sparse_tensor(cfg, 4, "cpu")
    t = SparseTensor(inds, vals, cfg["dims"], vals.shape[0], device="cpu")
    csf = build_csf(t, mode, block=64, row_tile=16)
    lin = build_linearized(t, block=64, row_tile=16)
    # the layouts store different bytes: padded entries, 16 against 12
    # bytes an entry
    csf_bytes = sum(x.numel() * x.element_size()
                    for x in (csf.row_ids, csf.other_ids, csf.vals))
    lin_bytes = sum(x.numel() * x.element_size()
                    for x in (lin.hi, lin.lo, lin.vals))
    assert csf_bytes != lin_bytes
    ranks = (35, 35, 35)
    for counts in (MTTKRP, TTMC):
        got = [counts.call(w.dims, w.nnz, ranks, mode) for w in (csf, lin)]
        assert got[0] == got[1] == counts.call(t.dims, t.nnz, ranks, mode)
        bounds = [readers.least_s(PEAK, *g) for g in got]
        assert bounds[0] == bounds[1] > 0


def test_roofline_reader_against_by_hand():
    rec = {"timers": {"mttkrp": 0.6}, "timed_fits": 5, "peak": PEAK,
           "dims": [40, 30, 50], "nnz": 1000,
           "mix": {"rank": 4, "niters": 2}}
    least = sum(max(MTTKRP.call(rec["dims"], 1000, (4, 4, 4), n)[0]
                    / 3.35e12,
                    MTTKRP.call(rec["dims"], 1000, (4, 4, 4), n)[1] / 67e12)
                for n in range(3)) * 2
    got = plugins.module("metrics", "mttkrp_roofline").read(rec)
    assert got == pytest.approx(100 * least / (0.6 / 5))
    assert plugins.module("metrics", "mttkrp_ms").read(rec) == \
        pytest.approx(120.0)
    # nothing to read: no roofline
    assert plugins.module("metrics", "ttmc_roofline").read(rec) is None
    assert plugins.module("metrics", "mttkrp_roofline").read(
        dict(rec, peak=None)) is None


def test_fit_ops_cover_the_kernels():
    dims, nnz = (41_000, 11_000, 75_000), 7_998_632
    cp = plugins.module("counts", "cp_als").fit_ops(
        dims, nnz, {"rank": 35, "niters": 20})
    kernel = sum(MTTKRP.call(dims, nnz, (35,) * 3, n)[1]
                 for n in range(3)) * 20
    assert cp > kernel
    tucker = plugins.module("counts", "tucker_hooi").fit_ops(
        dims, nnz, {"rank": [16, 16, 16], "niters": 8})
    assert tucker > sum(TTMC.call(dims, nnz, (16,) * 3, n)[1]
                        for n in range(3)) * 8
    assert isinstance(torch.tensor(cp).item(), float)
