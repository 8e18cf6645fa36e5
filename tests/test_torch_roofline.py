"""The port's H100 roofline (``repro_torch.utils.roofline``) and the
dry-run's tables (``repro_torch.utils.report``) against the reference's:
the ring wire model on the reference's HLO sample, the three terms with
the constants factored out, ``model_flops_estimate`` for every preset and
shape, and the tables' text on the same artifact dicts.  No process
group."""
import re
from pathlib import Path

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.models.config import SHAPES as REF_SHAPES
from repro.utils import report as ref_report
from repro.utils import roofline as ref_rl
from repro_torch import configs
from repro_torch.models.config import SHAPES
from repro_torch.utils import report
from repro_torch.utils import roofline as RL
from test_roofline import HLO_SAMPLE

ROOT = Path(__file__).resolve().parents[1]
REF_RECORDS = ref_rl.parse_collectives(HLO_SAMPLE)


@pytest.mark.parametrize("i", range(len(REF_RECORDS)))
def test_wire_model_matches_reference_parse(i):
    ref = REF_RECORDS[i]
    (got,) = RL.collectives_of([(ref["kind"], ref["bytes"], ref["group"])])
    assert (got["kind"], got["bytes"], got["group"]) == \
        (ref["kind"], ref["bytes"], ref["group"])
    assert got["wire"] == pytest.approx(ref["wire"], rel=1e-12)
    assert got["link"] == "ib"


def test_summary_matches_reference():
    got = RL.collective_summary(RL.collectives_of(
        [(c["kind"], c["bytes"], c["group"]) for c in REF_RECORDS]))
    assert got == ref_rl.collective_summary(REF_RECORDS)


@pytest.mark.parametrize("ranks,link", [
    (range(0, 8), "nvlink"), (range(8, 16), "nvlink"), ([2, 3], "nvlink"),
    (range(0, 16), "ib"), (range(4, 12), "ib"), (range(0, 256, 16), "ib"),
])
def test_link_of_a_group(ranks, link):
    ranks = list(ranks)
    (c,) = RL.collectives_of([("all-reduce", 1024, len(ranks), ranks)])
    assert c["link"] == link
    assert c["wire"] == pytest.approx(2 * 1024 * (len(ranks) - 1)
                                      / len(ranks))


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="broadcast"):
        RL.collectives_of([("broadcast", 8, 2)])


def test_h100_constants():
    assert (RL.BF16_FLOPS, RL.FP32_FLOPS, RL.HBM_BW) == \
        (989.4e12, 66.9e12, 3.35e12)
    assert (RL.NVLINK_BW, RL.IB_BW, RL.NODE_RANKS) == (450e9, 50e9, 8)


def test_no_tpu_constant_in_the_port():
    pat = re.compile(r"197e12|819e9|ICI_BW|TPU v5e|v5e")
    hits = [f"{p.relative_to(ROOT)}:{n}"
            for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            for n, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []


@pytest.mark.parametrize("dominant", ["compute", "memory", "collective"])
def test_analyze_values_terms(dominant):
    scale = {"compute": (4.0, 1.0, 1.0), "memory": (1.0, 4.0, 1.0),
             "collective": (1.0, 1.0, 4.0)}[dominant]
    # each term 1 ms at scale 1, half of compute and collective per part
    bf16, fp32 = 4.947e11 * scale[0], 3.345e10 * scale[0]
    nbytes = 3.35e9 * scale[1]
    nv, ib = 2.25e8 * scale[2], 2.5e7 * scale[2]
    r = RL.analyze_values(flops=bf16 + fp32, bytes_accessed=nbytes,
                          wire_bytes=nv + ib, collectives={}, n_chips=256,
                          model_flops=1e15, bf16_flops=bf16, nvlink_wire=nv)
    assert r.compute_s == pytest.approx(bf16 / RL.BF16_FLOPS
                                        + fp32 / RL.FP32_FLOPS)
    assert r.memory_s == pytest.approx(nbytes / RL.HBM_BW)
    assert r.collective_s == pytest.approx(nv / RL.NVLINK_BW + ib / RL.IB_BW)
    assert r.dominant == dominant
    assert r.bound_s == max(r.compute_s, r.memory_s, r.collective_s)
    assert r.useful_ratio == pytest.approx(1e15 / ((bf16 + fp32) * 256))
    assert r.flops == bf16 + fp32
    ref = ref_rl.Roofline(**r.to_json())
    assert ref.to_json() == r.to_json()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_model_flops_estimate_matches_reference(arch, shape):
    got = RL.model_flops_estimate(configs.get(arch), SHAPES[shape])
    want = ref_rl.model_flops_estimate(ref_configs.get(arch),
                                       REF_SHAPES[shape])
    assert got == want


def _artifacts(seed: int) -> list[dict]:
    """Artifact dicts with the dry-run's keys: LM cells, single and multi,
    a skipped cell and the cpals iterations."""
    rng = np.random.default_rng(seed)
    cells = []
    for arch in ("llama3.2-3b", "gemma-7b", "dbrx-132b", "cpals-yelp",
                 "cpals-nell2"):
        for mp in ("single", "multi"):
            shape = "iteration" if arch.startswith("cpals") else "train_4k"
            mesh = ({"pod": 2, "data": 16, "model": 16} if mp == "multi"
                    else {"data": 16, "model": 16})
            terms = rng.uniform(1e-4, 3.0, size=3)
            kinds = rng.choice(RL.KINDS, size=rng.integers(1, 4),
                               replace=False)
            cells.append({
                "cell": f"{arch}__{shape}__{mp}", "mesh": mesh,
                "compile_s": float(rng.uniform(0, 90)),
                "memory": {"argument_bytes": int(rng.integers(1, 2**36)),
                           "peak_estimate_gib": float(rng.uniform(0, 90))},
                "roofline": {
                    "compute_s": terms[0], "memory_s": terms[1],
                    "collective_s": terms[2],
                    "dominant": ("compute", "memory",
                                 "collective")[int(np.argmax(terms))],
                    "bound_s": float(terms.max()),
                    "useful_ratio": float(rng.uniform(0.05, 1.6)),
                    "collectives": {str(k): {"count": float(rng.integers(
                        1, 500)), "bytes": 1.0, "wire": 1.0}
                        for k in kinds}}})
    cells.append({"cell": "llama3.2-3b__long_500k__single",
                  "skipped": "pure full attention: 524k dense KV decode is "
                             "the wrong tool"})
    return cells


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_match_reference(seed):
    cells = _artifacts(seed)
    assert report.dryrun_table(cells) == ref_report.dryrun_table(cells)
    assert report.roofline_table(cells) == ref_report.roofline_table(cells)
    assert report.roofline_table(cells, single_only=False) == \
        ref_report.roofline_table(cells, single_only=False)
    assert report.pick_hillclimb(cells) == ref_report.pick_hillclimb(cells)
    for x in (0.0004, 0.25, 1.0, 37.5):
        assert report._fmt_s(x) == ref_report._fmt_s(x)


def test_report_main_reads_a_directory(tmp_path, capsys):
    import json

    for c in _artifacts(3):
        (tmp_path / f"{c['cell']}.json").write_text(json.dumps(c))
    cells = report.load_cells(tmp_path)
    assert [c["cell"] for c in cells] == sorted(
        c["cell"] for c in _artifacts(3))
    for section, want in (("dryrun", report.dryrun_table(cells)),
                          ("roofline", report.roofline_table(cells)),
                          ("pick", str(report.pick_hillclimb(cells)))):
        report.main(["--dir", str(tmp_path), "--section", section])
        assert capsys.readouterr().out.strip() == want
