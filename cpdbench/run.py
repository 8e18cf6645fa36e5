"""Run one cell of the benchmark once, on the card this process sees.

    python3 cpdbench/run.py --workload yelp-uniform.cp-restarts --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout, with nothing installed: the program is
imported from ``src/``.  The last line of standard output is the result
(see ``cpdbench/README.md``); the last lines of standard error are the
numbers compared with the reference, each beside its limit.  Exits with 2,
printing no result, without a CUDA card or with fewer cards than the cell
asks for, and with 3 if a forbidden module was loaded.
"""
import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the host threads of the run's one process, and the cores it is kept on,
# the same on every machine
THREADS = 4


def process_start() -> float:
    """When this process began, on ``time.perf_counter``'s clock, from
    ``/proc`` (to 10 ms); where that cannot be read, when this file began
    to run."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT
    return time.perf_counter() - max(0.0, uptime - started)


def pin(n: int = THREADS) -> None:
    """Keep this process, and the threads it starts, on ``n`` fixed cores
    of those it may use (the third to the sixth where there are six or
    more): where the scheduler moves it between cores, its fits' times
    spread twice as much from run to run."""
    try:
        avail = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return
    os.sched_setaffinity(0, avail[2:2 + n] if len(avail) >= 2 + n
                         else avail[-n:])


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's CUDA libraries go to ``build/kernels/`` by its own
    rule."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    pin()
    cache_env(ROOT)
    # the benchmark's folder must not shadow top-level modules
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA card: the benchmark runs on the card\n")
        return 2
    from cpdbench import harness

    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"{args.workload} needs {cell.chips} cards, "
                         f"{torch.cuda.device_count()} visible\n")
        return 2
    result = harness.Runner(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda"), t0).run()
    return 0 if result is not None else 3


if __name__ == "__main__":
    sys.exit(main())
