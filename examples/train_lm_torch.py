"""End-to-end training driver for the PyTorch port: train a ~100M-parameter
llama-style model for a few hundred steps on the synthetic pipeline, with
checkpoint/restart (the port's counterpart of ``examples/train_lm.py``).

  PYTHONPATH=src python examples/train_lm_torch.py                 # ~100M
  PYTHONPATH=src python examples/train_lm_torch.py --tiny --steps 30 \\
      --device cpu                                                 # CI-sized

It runs on the CUDA card unless ``--device`` names another device.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs as C
from repro_torch.launch.train import train

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--tiny", action="store_true")
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

if args.tiny:
    # smoke-sized model, quick check that the loop learns
    out = train("llama3.2-3b", smoke=True, steps=args.steps, batch=8,
                seq=64, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                device=args.device)
else:
    # ~100M params: override the llama3.2 config down to a trainable size
    cfg = dataclasses.replace(
        C.get("llama3.2-3b"), name="llama-100m", num_layers=8, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048, vocab=32_000,
        param_dtype="float32", compute_dtype="float32", remat=False)
    print(f"params ~= {cfg.param_count()/1e6:.0f}M")

    # reuse the launcher with the custom cfg
    orig_get = C.get
    C.get = lambda name: cfg if name == "llama-100m" else orig_get(name)
    try:
        out = train("llama-100m", smoke=False, steps=args.steps, batch=4,
                    seq=256, ckpt_dir=args.ckpt_dir, ckpt_every=100,
                    device=args.device)
    finally:
        C.get = orig_get

print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
      f"over {out['steps']} steps ({out['wall_s']:.0f}s)")
assert out["final_loss"] < out["first_loss"], "training did not reduce loss"
