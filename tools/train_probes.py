"""Probes of the LM training step on one CUDA card, beside ``chip_smoke.py``
phase 20 (llama3.2-3b at full width, bfloat16, remat ``full``):

1. the stacked body's parameter gradients: ``Model.forward`` splits each
   stacked leaf into its reps with one ``unbind`` a forward; the
   alternative, indexing ``leaf[r]`` once a rep, has a backward that
   writes a zero-filled copy of the whole leaf for every rep.  One
   forward + backward at batch 1 x 4096, each way three times, in turns:
   seconds and peak GB;
2. what ``torch.profiler`` costs around one 4-micro-batch AdamW step:
   with CUDA activity alone and with CPU + CUDA (as ``chip_smoke.py``'s
   ``profiled``), the step, the profiler's exit and ``key_averages``.

  python3 tools/train_probes.py        # on a machine with the card
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

DEV = "cuda"


def _indexed(tree_map):
    """``tree_map`` with the forward's ``unbind`` of the stacked leaves
    left out, so each rep indexes the stacked tensor (``leaf[r]``)."""
    def fn(f, tree):
        if getattr(f, "__code__", None) is not None and \
                f.__code__.co_names == ("unbind",):
            return tree_map(lambda a: a, tree)
        return tree_map(f, tree)
    return fn


def stacked_backward(model, batch, card: str) -> None:
    unbind = T.tree_map
    try:
        for way in ("unbind", "index", "index", "unbind", "unbind", "index"):
            T.tree_map = unbind if way == "unbind" else _indexed(unbind)
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = model.loss(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"[probe] stacked leaves by {way}: forward {t1 - t0:.4f} s,"
                  f" backward {t2 - t1:.4f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, loss "
                  f"{loss.item():.6f} on {card}", flush=True)
            del loss
    finally:
        T.tree_map = unbind
    model.zero_grad(set_to_none=True)


def profiler_cost(model, cfg, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    opt = adamw(lr=3e-4)
    state = opt.init(model.params())
    step = make_train_step(model, opt, micro_batches=4)
    pipe = TokenPipeline(cfg, 4, 4096, 0, device=DEV)
    state, _ = step(state, pipe.batch_at(0), 0)
    for i, acts in enumerate(([ProfilerActivity.CUDA],
                              [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        batch = pipe.batch_at(1 + i)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            state, _ = step(state, batch, 1 + i)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        t3 = time.perf_counter()
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        t4 = time.perf_counter()
        print(f"[probe] torch.profiler with {[a.name for a in acts]}: step "
              f"{t2 - t1:.3f} s, exit {t3 - t2:.3f} s, key_averages "
              f"{t4 - t3:.3f} s; {sum(ev.count for ev in kernels)} kernels, "
              f"device {sum(ev.device_time_total for ev in kernels) / 1e3:.1f}"
              f" ms on {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_probes: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = configs.get("llama3.2-3b")
    model = Model(cfg).init(torch.Generator(device=DEV).manual_seed(0),
                            DEV)
    stacked_backward(model, TokenPipeline(cfg, 1, 4096, 0,
                                          device=DEV).batch_at(0), card)
    profiler_cost(model, cfg, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
