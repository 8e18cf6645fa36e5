"""Probes of DTensor's host cost on one CUDA card, beside ``chip_smoke.py``
phase 21 (llama3.2-3b at full width, bfloat16, a (data=1, model=1) grid
on one NCCL rank, every redistribution local):

1. a decode step at batch 4 after a 512-token prefill, without and with
   the activation hook (parameters placed, cache placed), in turns, three
   rounds of 8 steps each way: ms a step, each step ending in a device
   synchronisation;
2. 4 decode steps with the hook under ``cProfile``: the host time by the
   file it is spent in (DTensor's dispatch, its sharding propagation, its
   redistribution, the model's own code, the rest), as shares of the
   profiled time (``cProfile`` inflates every Python call, so only the
   shares are read), and the functions with the most own time.

  python3 tools/mesh_probes.py        # on a machine with the card
"""
import cProfile
import pstats
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.dist.collectives import (init_process_group_for,  # noqa: E402
                                          make_mesh)
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import Model  # noqa: E402

DEV = torch.device("cuda")
ARCH = "llama3.2-3b"
BATCH, PROMPT, STEPS, ROUNDS, PROFILED = 4, 512, 8, 3, 4
# where a host second goes: the first matching part of its file's path
PARTS = (("DTensor sharding propagation", "tensor/_sharding_prop"),
         ("DTensor op strategies", "tensor/_ops/"),
         ("DTensor redistribution", "tensor/_redistribute"),
         ("DTensor dispatch", "tensor/_dispatch"),
         ("DTensor placements and specs", "tensor/placement_types"),
         ("DTensor specs", "tensor/_dtensor_spec"),
         ("DTensor API (from_local, to_local)", "tensor/_api"),
         ("the model (repro_torch)", "repro_torch/"),
         ("torch's Python (the rest of torch)", "torch/"))


def decode_ms(model, tokens, cache, pos0: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        model.decode_step(tokens, cache, pos0 + i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    own = init_process_group_for(DEV)
    try:
        grid = make_mesh((1, 1), ("data", "model"))
        cfg = configs.get(ARCH)
        rules = M.rules_for(cfg)
        plain = Model(cfg).init(torch.Generator(device=DEV).manual_seed(0),
                                DEV)
        placed = Model(cfg)
        placed.load_state_dict({k: v.clone() for k, v in
                                plain.state_dict().items()}, assign=True)
        M.place_model(placed, M.sharding_fn(grid, rules))
        ids = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (BATCH, PROMPT), dtype=np.int32), device=DEV)
        n = PROMPT + ROUNDS * STEPS + PROFILED + 2
        pcache = plain.init_cache(BATCH, n)
        plain.prefill({"tokens": ids}, pcache)
        M.install(grid, rules)
        mcache = placed.init_cache(BATCH, n)
        placed.prefill({"tokens": ids}, mcache)
        M.uninstall()
        tok = ids[:, -1:]
        times = {"without": [], "with": []}
        pos = PROMPT
        for _ in range(ROUNDS):
            times["without"].append(decode_ms(plain, tok, pcache, pos))
            M.install(grid, rules)
            try:
                times["with"].append(decode_ms(placed, tok, mcache, pos))
            finally:
                M.uninstall()
            pos += STEPS
        for way, ms in times.items():
            print(f"[probe] {ARCH} decode at batch {BATCH}, cache {n}, "
                  f"{way} the hook: " + " / ".join(f"{t:.3f}" for t in ms)
                  + f" ms a step ({STEPS} steps a round) on {card}")

        M.install(grid, rules)
        prof = cProfile.Profile()
        try:
            torch.cuda.synchronize()
            prof.enable()
            for i in range(PROFILED):
                placed.decode_step(tok, mcache, pos + i)
            torch.cuda.synchronize()
            prof.disable()
        finally:
            M.uninstall()
        stats = pstats.Stats(prof)
        total = sum(v[2] for v in stats.stats.values())
        shares = dict.fromkeys([p for p, _ in PARTS] + ["other"], 0.0)
        for (path, _, _), v in stats.stats.items():
            part = next((p for p, key in PARTS if key in path), "other")
            shares[part] += v[2]
        print(f"[probe] {PROFILED} decode steps with the hook under cProfile: "
              f"{total:.3f} s of own time; shares: " + "; ".join(
                  f"{p} {t / total:.3f}" for p, t in shares.items())
              + f" on {card}")
        top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
        for (path, line, fn), v in top:
            print(f"[probe]   own {v[2] / total:.3f}, {v[1]} calls: {fn} "
                  f"({'/'.join(Path(path).parts[-3:])}:{line})")
    finally:
        if own:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
