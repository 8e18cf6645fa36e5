"""Training launcher: checkpointing, restart, straggler monitoring and
optional gradient compression (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
      --device cpu

It runs on the CUDA card unless ``--device`` (``device=``) names another
device, and raises without a card.  The parameters are drawn on the device
from a ``torch.Generator`` seeded with ``seed``; the checkpoints hold
``(params, opt_state)`` at the reference's key paths, so a run resumes from
a checkpoint either package wrote.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.coo import DeviceLike, resolve_device
from repro_torch.data import TokenPipeline
from repro_torch.dist import StragglerMonitor
from repro_torch.dist.compress import init_error_feedback
from repro_torch.dist.straggler import record_step_times
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models.params import tree_walk
from repro_torch.optim import OPTIMIZERS


def train(arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str | None, ckpt_every: int = 25, lr: float = 3e-4,
          optimizer: str = "adamw", grad_compress: bool = False,
          seed: int = 0, log_every: int = 10, resume: bool = True,
          device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if smoke:
        cfg = configs.smoke_of(cfg)
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                            dev)
    opt = OPTIMIZERS[optimizer](lr=lr)

    params = model.params()
    opt_state = opt.init(params)
    if grad_compress:
        opt_state = dict(opt_state, ef=init_error_feedback(params))
    step0 = 0

    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    if mgr is not None and resume and mgr.latest_step() is not None:
        (saved, opt_state), extra = mgr.restore((params, opt_state))
        with torch.no_grad():
            for p, s in tree_walk(params, saved):
                p.copy_(s)
        step0 = int(extra["step"])
        print(f"[train] resumed from step {step0}")

    train_step = make_train_step(model, opt, grad_compress=grad_compress)
    pipe = TokenPipeline(cfg, batch, seq, seed=seed, device=dev)
    mon = StragglerMonitor()

    losses = []
    t_start = time.time()
    for step in range(step0, steps):
        t0 = time.time()
        batch_data = pipe.batch_at(step)
        opt_state, metrics = train_step(opt_state, batch_data, step)
        loss = float(metrics["loss"])
        losses.append(loss)
        record_step_times(mon, time.time() - t0)
        straggler_flags = mon.check()
        if step % log_every == 0 or step == steps - 1:
            tok_s = batch * seq / max(time.time() - t0, 1e-9)
            print(f"[train] step {step:5d}  loss {loss:.4f}  "
                  f"{tok_s:,.0f} tok/s")
            if straggler_flags:
                print("[train] stragglers: " + ", ".join(
                    f"host{h}:{kind}"
                    for h, kind in sorted(straggler_flags.items())))
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, (params, opt_state))
    if mgr is not None:
        mgr.save(steps, (params, opt_state))
        mgr.wait()
    wall = time.time() - t_start
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "steps": steps - step0, "wall_s": wall, "losses": losses}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=list(OPTIMIZERS))
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, lr=args.lr,
                optimizer=args.optimizer, grad_compress=args.grad_compress,
                device=args.device)
    print(f"[train] done: loss {out['first_loss']:.4f} -> "
          f"{out['final_loss']:.4f} in {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
