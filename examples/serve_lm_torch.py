"""Batched serving example on the PyTorch port: prefill a batch of prompts,
then decode greedily against the KV cache and the recurrent states, for any
of the ten LM archs (dense, MoE, RWKV-6, RG-LRU hybrid, M-RoPE embeddings,
encoder-decoder).

  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
  PYTHONPATH=src python examples/serve_lm_torch.py --arch rwkv6-3b --device cpu

Smoke widths, random weights drawn from a seed; without ``--device`` it
runs on the CUDA card.
"""
import argparse

from repro_torch import configs
from repro_torch.launch.serve import serve

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="llama3.2-3b", choices=configs.ARCH_NAMES)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--prompt-len", type=int, default=32)
ap.add_argument("--gen", type=int, default=16)
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

out = serve(args.arch, smoke=True, batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen, device=args.device)
print(f"arch={args.arch}  prefill={out['prefill_s']:.2f}s  "
      f"decode={out['decode_s']:.2f}s  ({out['decode_tok_s']:,.0f} tok/s)")
for i in range(min(2, args.batch)):
    print(f"  request {i}: generated {out['tokens'][i][:10].tolist()} ...")
