"""The readings that a cell's limits are set from (``cells/<cell>.json``),
on the card, at the cell's own size.

For each seed: the configuration's tensor, ``ingest`` and a warm-up fit
per mix, then the mix's first window fit (``FIT_STREAM + 0``) by the
program and, on the first ``--control-seeds`` seeds, by the control (the
reference in TF32), each judged by the method's judge in
``reference.METHODS``.  One JSON line a reading
goes to standard output and to ``--out``.

    python3 cpdbench/calibrate.py --config yelp-uniform \\
        --mixes cp-restarts,tucker-restarts --seeds 101-112 \\
        --control-seeds 3 --out build/calibrate_yelp.jsonl

The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds_of(text: str) -> list[int]:
    """``"101-112"`` or ``"5,9,12"``."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def readings(cfg, mixes, seed, control: bool, device):
    """Yield one dict a (mix, side) for ``seed``."""
    from cpdbench import generate, harness, reference

    dev = harness.Device(device)
    inds, vals = generate.sparse_tensor(cfg, seed, device)
    handle = None
    fits = {}
    for mix_name, mix in mixes.items():
        method = reference.METHODS[mix["method"]]
        program = harness.Program(cfg, mix)
        if handle is None:
            handle = program.ingest(inds, vals, device)
        program.fit(handle, generate.initial_factors(
            cfg, mix, seed, generate.WARMUP_STREAM, device))
        init = generate.initial_factors(cfg, mix, seed, generate.FIT_STREAM,
                                        device)
        states = [] if method["states"] else None
        dev.sync()
        t = time.perf_counter()
        dec, value = program.fit(handle, init, states=states)
        fit_s = time.perf_counter() - t
        got = {f: getattr(dec, f) for f in method["fields"]}
        got.update(fit=value, states=states)
        fits[mix_name] = (init, got, fit_s)
    del handle, program, dec
    dev.free()
    for mix_name, mix in mixes.items():
        init, got, fit_s = fits[mix_name]
        method = reference.METHODS[mix["method"]]
        cache: dict = {}
        t = time.perf_counter()
        row = method["judge"](inds, vals, init, mix, got, cache=cache)
        # both sides start from the very factors drawn here
        row["init_gap"] = 0.0
        yield {"seed": seed, "mix": mix_name, "side": "program",
               "fit_s": fit_s, "judge_s": time.perf_counter() - t, **row}
        if control:
            states = [] if method["states"] else None
            t = time.perf_counter()
            ctl = method["run"](inds, vals, init, mix,
                                reference.Precision("tf32"), states=states)
            ctl_s = time.perf_counter() - t
            ctl.update(states=states)
            row = method["judge"](inds, vals, init, mix, ctl, cache=cache)
            row["init_gap"] = 0.0
            yield {"seed": seed, "mix": mix_name, "side": "control",
                   "control_s": ctl_s, **row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mixes", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from cpdbench import plugins

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA card\n")
        return 2
    cfg = plugins.data("configs", args.config)
    mixes = {m: plugins.data("traffic", m) for m in args.mixes.split(",")}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a", encoding="utf-8") as f:
        for i, seed in enumerate(seeds_of(args.seeds)):
            for row in readings(cfg, mixes, seed, i < args.control_seeds,
                                torch.device("cuda")):
                line = json.dumps(row)
                print(line, flush=True)
                f.write(line + "\n")
                f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
