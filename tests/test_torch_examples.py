"""The PyTorch port's CP examples (``examples/*_torch.py``) on the CPU,
each run in this process through ``runpy`` with small arguments and
``--device cpu``: the quickstart (the original's tensor shape, rank and
iterations), the end-to-end Table III ablation at scale 0.0005 and 2
iterations (the method registry skipped), and the embedding compression
as the original runs it (its ``fit > 0.5`` assertion kept).  Every ``import``
statement the run executes is recorded, and none may name ``jax`` or the
reference package ``repro``; nor may the example files.  Without a card
and without ``--device``, an example raises instead of running on the
CPU."""
import ast
import builtins
import math
import runpy
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart_torch": ["--device", "cpu"],
    "decompose_end_to_end_torch": ["--device", "cpu", "--scale", "0.0005",
                                   "--iters", "2", "--skip-methods"],
    "compress_embeddings_torch": ["--device", "cpu"],
}
ABLATION = ("gather_scatter", "segment", "auto")


def _reference(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("jax", "repro"))


def _run(name: str, argv: list, monkeypatch):
    """The example's ``main(argv)`` and the modules its run imported."""
    seen = []
    real = builtins.__import__

    def spy(mod, globals=None, locals=None, fromlist=(), level=0):
        if level == 0:
            seen.append(mod)
        return real(mod, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", spy)
    ns = runpy.run_path(str(ROOT / "examples" / f"{name}.py"))
    out = ns["main"](argv)
    monkeypatch.undo()
    return out, seen


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu_without_the_reference(name, monkeypatch):
    out, seen = _run(name, EXAMPLES[name], monkeypatch)
    assert "repro_torch.methods" in seen or "repro_torch.api" in seen
    assert not [m for m in seen if _reference(m)]
    if name == "quickstart_torch":
        dec = out["decomp"]
        assert [tuple(a.shape) for a in dec.factors] == [(500, 16),
                                                         (400, 16),
                                                         (300, 16)]
        assert 0.0 < float(dec.fit) < 1.0
        # 50 000 drawn, the duplicate coordinates summed
        assert 49_000 < out["tensor"].nnz <= 50_000
    elif name == "decompose_end_to_end_torch":
        # the three impl policies from one state: the same fit
        for data in ("yelp", "nell-2"):
            fits = [out[(data, "cp_als", impl)] for impl in ABLATION]
            assert all(math.isfinite(f) for f in fits)
            assert max(fits) - min(fits) <= 1e-4, (data, fits)
    else:
        assert float(out["decomp"].fit) > 0.5
        assert out["rel_err"] < 0.5


def test_examples_import_neither_jax_nor_the_reference():
    for name in EXAMPLES:
        tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if _reference(m)], name


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_example_raises_without_a_card(monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run("quickstart_torch", [], monkeypatch)
