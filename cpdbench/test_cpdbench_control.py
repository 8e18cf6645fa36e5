"""The control of each cell's comparison, at a size a test run holds: the
reference in TF32 (every multiplication's operands rounded to 10 mantissa
bits), put in the program's place, has to come out as not correct by the
cell's own limits, while the program from the same start comes out as
correct.  On the card, at the cells' sizes, ``calibrate.py`` reads the
same; the limits in ``cells/`` were set from those readings."""
import pytest
import torch

from cpdbench import calibrate, harness

CELLS = ("yelp-uniform.cp-restarts", "yelp-uniform.tucker-restarts")
# each configuration at a size where, as at the cell's own size, the
# program's readings fall inside the cell's limits
SMALL = {"yelp-uniform": {"dims": [600, 160, 1100], "nnz": 100000}}


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a test process: the suite runs several processes at
    once, and these fits gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fails(row: dict, limits: dict) -> bool:
    return any(row[name] > limit for name, limit in limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = harness.load_cell(name)
    cfg = dict(cell.cfg, **SMALL[cell.cfg["name"]])
    limits = cell.checks["limits"]
    rows = list(calibrate.readings(cfg, {cell.name: cell.mix}, 7, True,
                                   torch.device("cpu")))
    program = [r for r in rows if r["side"] == "program"]
    control = [r for r in rows if r["side"] == "control"]
    assert len(program) == len(control) == 1
    assert not fails(program[0], limits), program[0]
    assert fails(control[0], limits), control[0]
