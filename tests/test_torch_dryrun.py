"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's: ``cpals-yelp``'s distributed iteration on a (2, 2, 2) grid,
with and without ``shard_c``, and on both production grids, its ``info``
and its collectives' result and wire bytes; a narrowed ``smoke_of`` LM
cell on a (4, 2) grid; llama3.2-3b ``train_4k`` (also with
``rules:flash_q``), gemma-7b ``train_4k`` and rwkv6-3b ``decode_32k`` at
full width on ``meta``; llama's batch-of-one step on a one-rank grid;
each collective route counted once; the capability gate; the front
door's ``dryrun`` writing an artifact the report reads.

The fake process group is process-global, so the port's side runs in one
subprocess (which re-creates its group at 8, 256, 512 and 1 ranks), the
reference's in another (XLA host devices), and the front door in a third;
the three run at once."""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

PORT = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch import configs
from repro_torch.dist.collectives import axis_product, make_mesh, psum
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import batch_sharding, rules_for, spec_for
from repro_torch.models import Model
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.params import tree_items

out_dir = sys.argv[1]
out = {}

def records(fn):
    mode = D.StepTrace()
    with mode:
        fn()
    return [list(r[:3]) for r in mode.records]

def local_bytes(shape, spec, itemsize, mesh):
    n = itemsize
    for d, size in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        n *= size // (axis_product(mesh, e if isinstance(e, tuple) else (e,))
                      if e else 1)
    return n

def arguments(cfg, shape, mesh):
    # the train step's arguments, leaf by leaf through spec_for: the
    # parameters, AdamW's two float32 moments, the batch
    rules = rules_for(cfg)
    total = 0
    for _, s in tree_items(Model(cfg).param_specs()):
        spec = spec_for(s.axes, s.shape, mesh, rules)
        total += local_bytes(s.shape, spec, cfg.pdtype.itemsize, mesh)
        total += 2 * local_bytes(s.shape, spec, 4, mesh)
    for sh, dt, kind in configs.batch_shapes(cfg, shape).values():
        spec = batch_sharding(mesh, rules, kind, sh).spec
        total += local_bytes(sh, spec, dt.itemsize, mesh)
    return total

def cpals(mesh, shard_c=False):
    rl, counts, info = D.trace_cpals("cpals-yelp", mesh, shard_c=shard_c)
    info = {k: v for k, v in info.items() if k != "model_flops"}
    return {"info": json.loads(json.dumps(info)),
            "summary": rl.collectives, "wire": rl.wire_bytes,
            "flops": rl.flops, "bytes": rl.bytes_accessed}

D.init_fake_group(8)
mesh = make_mesh((4, 2), ("data", "model"), device="cuda")
x = torch.empty(6, 5, device="meta")
out["routes"] = {
    "psum": records(lambda: psum(x, mesh, "model")),
    "redistribute": records(lambda: DTensor.from_local(
        x, mesh.device_mesh, [Replicate(), Partial()]).redistribute(
            mesh.device_mesh, [Replicate(), Replicate()])),
    "shard_to_shard": records(lambda: DTensor.from_local(
        torch.empty(4, 8, device="meta"), mesh.device_mesh,
        [Replicate(), Shard(0)]).redistribute(
            mesh.device_mesh, [Replicate(), Shard(1)])),
    "all_to_all": records(lambda: dist.all_to_all_single(
        torch.empty(8, 5, device="meta"), torch.empty(8, 5, device="meta"),
        group=mesh.group("model"))),
}

full = configs.get("llama3.2-3b")
cfg = dataclasses.replace(configs.smoke_of(full), vocab=1024, d_model=128,
                          d_ff=256, num_heads=8, num_kv_heads=2)
ov = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
      if getattr(cfg, f.name) != getattr(full, f.name)}
shape = ShapeConfig("mini", 128, 8, "train")
art = D.run_cell("llama3.2-3b", "mini", multi_pod=False, overrides=ov,
                 out_dir=out_dir, mesh=mesh, shape=shape)
out["mini"] = {"art": art, "arguments": arguments(cfg, shape, mesh)}

grid = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cuda")
out["cpals"] = {"222": cpals(grid), "222_shard_c": cpals(grid, True)}

dist.destroy_process_group()
D.init_fake_group(256)
mesh = D.make_production_mesh(device="cuda")
out["cpals"]["single"] = cpals(mesh)
art = D.run_cell("llama3.2-3b", "train_4k", multi_pod=False,
                 out_dir=out_dir, mesh=mesh)
out["llama"] = {"art": art, "arguments": arguments(
    full, SHAPES["train_4k"], mesh)}
out["llama_flash_q"] = D.run_cell("llama3.2-3b", "train_4k", multi_pod=False,
                                  overrides={"rules:flash_q": "model"},
                                  out_dir=out_dir, tag="flash_q", mesh=mesh)
out["gemma"] = D.run_cell("gemma-7b", "train_4k", multi_pod=False,
                          out_dir=out_dir, mesh=mesh)
# RWKV-6's heads (40) split by no production axis: the groups gathered
# before they are unflattened, the recurrence on each rank's block
out["rwkv"] = D.run_cell("rwkv6-3b", "decode_32k", multi_pod=False,
                         out_dir=out_dir, mesh=mesh)

dist.destroy_process_group()
D.init_fake_group(512)
out["cpals"]["multi"] = cpals(D.make_production_mesh(multi_pod=True,
                                                     device="cuda"))

# one rank, a batch of one: each batch dim a split over an axis of size one
dist.destroy_process_group()
D.init_fake_group(1)
one = make_mesh((1, 1), ("data", "model"), device="cuda")
out["one_rank"] = D.run_cell("llama3.2-3b", "train_1x4096", multi_pod=False,
                             shape=ShapeConfig("train_1x4096", 4096, 1,
                                               "train"),
                             out_dir=out_dir, tag="one_rank", mesh=one)
out["modules"] = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro."))
print("RESULT " + json.dumps(out))
"""

REFERENCE = r"""
import json
import jax
from repro.core.distributed import build_dist_cpals_lowered
from repro.launch.mesh import make_production_mesh
from repro.utils import roofline as RL

def one(mesh, shard_c=False):
    lowered, info = build_dist_cpals_lowered("cpals-yelp", mesh,
                                             shard_c=shard_c)
    colls = RL.parse_collectives(lowered.compile().as_text())
    info = {k: v for k, v in info.items() if k != "model_flops"}
    return {"info": json.loads(json.dumps(info)),
            "summary": RL.collective_summary(colls),
            "wire": sum(c["wire"] for c in colls)}

grid = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {"222": one(grid), "222_shard_c": one(grid, True),
       "single": one(make_production_mesh()),
       "multi": one(make_production_mesh(multi_pod=True))}
print("RESULT " + json.dumps(out))
"""


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def _result(name: str, p: subprocess.Popen) -> str:
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise AssertionError(f"{name}: no result in {TIMEOUT_S} s")
    assert p.returncode == 0, (
        f"{name} exited {p.returncode}\nstdout:\n{out[-3000:]}\n"
        f"stderr:\n{err[-5000:]}")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    art = tmp_path_factory.mktemp("dryrun")
    tag = f"pytest{os.getpid()}"
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(PORT), str(art)],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "reference": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REFERENCE)], cwd=ROOT,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=512",
                     JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch", "dryrun", "--workload",
             "cpals-yelp", "--tag", tag], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    outs = {name: _result(name, p) for name, p in procs.items()}
    res = {name: json.loads(re.search(r"^RESULT (.*)$", outs[name],
                                      re.M).group(1))
           for name in ("port", "reference")}
    res["cli"] = {"out": outs["cli"], "tag": tag}
    yield res
    from repro_torch.launch.dryrun import ARTIFACTS

    (ARTIFACTS / f"cpals-yelp__iteration__single__{tag}.json").unlink(
        missing_ok=True)


@pytest.mark.parametrize("grid", ["222", "222_shard_c", "single", "multi"])
def test_cpals_iteration_matches_reference(runs, grid):
    got, want = runs["port"]["cpals"][grid], runs["reference"][grid]
    assert got["info"] == want["info"]
    assert set(got["summary"]) == set(want["summary"])
    for kind, w in want["summary"].items():
        assert got["summary"][kind]["bytes"] == pytest.approx(
            w["bytes"], rel=1e-2), kind
        assert got["summary"][kind]["wire"] == pytest.approx(
            w["wire"], rel=1e-2), kind
    assert got["wire"] == pytest.approx(want["wire"], rel=1e-2)
    assert got["flops"] > 0 and got["bytes"] > 0


def test_each_collective_route_counted_once(runs):
    routes = runs["port"]["routes"]
    assert routes["psum"] == [["all-reduce", 6 * 5 * 4, 2]]
    assert routes["redistribute"] == [["all-reduce", 6 * 5 * 4, 2]]
    # global (8, 8): rows split in two, then columns: (8, 4) a rank
    assert routes["shard_to_shard"] == [["all-to-all", 8 * 4 * 4, 2]]
    assert routes["all_to_all"] == [["all-to-all", 8 * 5 * 4, 2]]


KEYS = {"cell", "mesh", "n_chips", "memory", "roofline"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_estimate_gib"}
ROOFLINE = {"flops", "bytes_accessed", "wire_bytes", "compute_s",
            "memory_s", "collective_s", "dominant", "model_flops",
            "useful_ratio", "collectives", "bound_s"}


def _check_keys(art: dict) -> None:
    assert KEYS <= set(art)
    assert MEMORY <= set(art["memory"])
    assert ROOFLINE == set(art["roofline"])


def test_mini_lm_cell(runs):
    mini = runs["port"]["mini"]
    art = mini["art"]
    _check_keys(art)
    r = art["roofline"]
    assert art["cell"] == "llama3.2-3b__mini__single"
    assert art["mesh"] == {"data": 4, "model": 2} and art["n_chips"] == 8
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    grads = [r["collectives"].get(k, {"wire": 0.0})["wire"]
             for k in ("all-reduce", "reduce-scatter")]
    assert max(grads) > 0, r["collectives"]
    assert art["memory"]["argument_bytes"] == mini["arguments"]
    assert art["memory"]["temp_bytes"] > 0


def test_llama_train_4k_at_full_width(runs):
    """Full width on meta, the production single-pod grid: the bf16
    products over the grid cover 6 N D, and the step's arguments are the
    leaves' local shards."""
    llama = runs["port"]["llama"]
    art = llama["art"]
    _check_keys(art)
    assert art["n_chips"] == 256 and art["optimizer"] == "adamw"
    assert art["split"]["bf16_flops"] * 256 >= art["roofline"]["model_flops"]
    assert art["memory"]["argument_bytes"] == llama["arguments"]
    assert art["memory"]["alias_bytes"] > 0
    assert art["probe"]["reps"] == 28


# the production train step split as the reference's rules split it: the
# residual stream reduced at each block's output (the MLP on its 1/16 of
# 'mlp'), the cross-entropy over each rank's vocab block
USEFUL_MIN, PEAK_MAX_GIB, FLASH_Q_GAIN = 0.4, 80.0, 1.25


def test_gemma_train_4k_splits_as_the_rules_say(runs):
    """gemma-7b's 16 heads divide the model axis: every layer splits 16
    ways, so the useful ratio is at least 0.4 and a rank's peak fits the
    card's 80 GiB."""
    art = runs["port"]["gemma"]
    _check_keys(art)
    assert art["roofline"]["useful_ratio"] >= USEFUL_MIN, art["roofline"]
    assert art["memory"]["peak_estimate_gib"] <= PEAK_MAX_GIB, art["memory"]


def test_llama_train_4k_fits_and_flash_q_splits_its_attention(runs):
    """llama3.2-3b's 24 heads do not divide the model axis: its attention
    runs whole on each model rank, yet a rank's peak fits 80 GiB; with
    ``rules:flash_q`` each rank runs its own q blocks, and the useful ratio
    rises at least 1.25x."""
    base = runs["port"]["llama"]["art"]
    fq = runs["port"]["llama_flash_q"]
    _check_keys(fq)
    assert fq["overrides"] == {"rules:flash_q": "model"}
    for art in (base, fq):
        assert art["memory"]["peak_estimate_gib"] <= PEAK_MAX_GIB, \
            art["memory"]
    assert (fq["roofline"]["useful_ratio"]
            >= FLASH_Q_GAIN * base["roofline"]["useful_ratio"])


def test_one_rank_batch_of_one_step_traces(runs):
    """The one-rank grid at a batch of one (every split over an axis of
    size one): llama's whole train step traces, and on one rank it moves
    nothing between ranks."""
    art = runs["port"]["one_rank"]
    _check_keys(art)
    assert art["cell"] == "llama3.2-3b__train_1x4096__single__one_rank"
    assert art["n_chips"] == 1
    r = art["roofline"]
    assert r["flops"] > 0 and r["wire_bytes"] == 0
    assert art["split"]["bf16_flops"] >= r["model_flops"]


def test_rwkv_decode_on_the_production_grid(runs):
    art = runs["port"]["rwkv"]
    _check_keys(art)
    assert art["cell"] == "rwkv6-3b__decode_32k__single"
    assert art["roofline"]["flops"] > 0 and art["memory"]["temp_bytes"] > 0


def test_front_door_dryrun_writes_an_artifact(runs, capsys):
    from repro_torch.launch.dryrun import ARTIFACTS
    from repro_torch.utils import report

    cli = runs["cli"]
    path = ARTIFACTS / f"cpals-yelp__iteration__single__{cli['tag']}.json"
    art = json.loads(path.read_text())
    _check_keys(art)
    assert "**segment**" in cli["out"]  # the plan table came first
    assert art["info"]["local_impls"] == ["segment", "segment", "scatter"]
    report.main(["--dir", str(ARTIFACTS), "--section", "roofline"])
    table = capsys.readouterr().out
    assert f"| cpals-yelp__iteration__{cli['tag']} |" in table


def test_no_jax_or_reference_in_the_port(runs):
    assert runs["port"]["modules"] == []
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    for rel in ("launch/dryrun.py", "utils/roofline.py", "utils/report.py",
                "core/distributed.py", "api/cli.py"):
        text = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert not [ln for ln in text.splitlines() if pat.match(ln)], rel


def test_run_cpals_rejects_non_dist_methods():
    from repro_torch.launch.dryrun import run_cpals

    with pytest.raises(ValueError, match="supports_dist"):
        run_cpals("cpals-yelp", multi_pod=False, method="tucker_hooi")
