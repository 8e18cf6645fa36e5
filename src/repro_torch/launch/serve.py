"""Serving launcher: the decomposition-serving path for the paper's own
CP-ALS workloads (plan-driven decompose, then batched reconstruction
queries), and the LM substrate's token-serving loop (batched prefill, then
greedy decode against the KV cache).

Counterpart of ``repro.launch.serve``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch cpals-yelp \\
      --smoke --batch 256 --queries 2048 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

Both run on the CUDA card unless ``--device`` (``device=``) names another
device, and raise without a card.  The decomposition path drives
:class:`repro_torch.api.Session` and shares its RunConfig with ``python -m
repro_torch serve``.  The LM path runs every LM arch: token or embedding
inputs, M-RoPE positions and an encoder-decoder's source frames are built
as the reference builds them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api.session import _sync
from repro_torch.configs import CPALS_DATASET
from repro_torch.core.coo import DeviceLike, resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import Model
from repro_torch.models import layers as L

# an encoder-decoder's source frames a request (the reference's serve)
SRC_LEN = 16


def generate(model: Model, batch: dict, *, gen: int) -> dict:
    """Prefill ``batch`` (``tokens`` (B, S), or ``embeds`` (B, S, D); M-RoPE
    ``positions`` (3, B, S); an encoder-decoder's ``src_embeds`` (B, T, D))
    into a fresh cache of S + gen slots (and T cross slots), then decode
    ``gen - 1`` more tokens greedily, M-RoPE positions at ``S + i``.

    Returns the ``gen`` tokens a row (numpy), each step's last-position
    logits (B, gen, V) on the model's device, the last metrics of the
    prefill (the MoE blocks'), and the prefill and decode seconds, each
    ending in a device synchronisation."""
    cfg = model.cfg
    dev = model.device
    inputs = batch["embeds"] if cfg.input_mode == "embeds" \
        else batch["tokens"]
    b, s = inputs.shape[:2]
    src_len = batch["src_embeds"].shape[1] if cfg.encdec else 0
    cache = model.init_cache(b, s + gen, src_len=src_len)
    prefill = make_prefill_step(model)
    step = make_serve_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache, metrics = prefill(batch, cache)
    toks = [logits[:, -1].argmax(dim=-1).to(torch.int32)]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    steps = [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        positions = None
        if cfg.rope == "mrope":
            positions = torch.full((3, b, 1), s + i, dtype=torch.int32,
                                   device=dev)
        logits, cache = step(toks[-1][:, None], cache, s + i, positions)
        steps.append(logits[:, -1])
        toks.append(logits[:, -1].argmax(dim=-1).to(torch.int32))
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {"tokens": torch.stack(toks, dim=1).cpu().numpy(),
            "logits": torch.stack(steps, dim=1), "metrics": metrics,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tok_s": b * (gen - 1) / max(t_decode, 1e-9)}


def serve_batch(model: Model, prompts: np.ndarray,
                rng: np.random.Generator) -> dict:
    """The reference's prefill batch for ``prompts`` (B, S) int32: token
    ids, or their embeddings through the table for an ``embeds`` model;
    M-RoPE positions 0..S-1 on all three streams; an encoder-decoder's
    ``src_embeds`` (B, 16, D), drawn from ``rng`` after the prompts."""
    cfg = model.cfg
    dev = model.device
    b, s = prompts.shape
    tokens = torch.as_tensor(prompts, device=dev)
    out = {}
    if cfg.input_mode == "embeds":
        with torch.no_grad():
            out["embeds"] = L.embed({"table": model.embed.table}, cfg, tokens)
    else:
        out["tokens"] = tokens
    if cfg.rope == "mrope":
        out["positions"] = torch.arange(s, dtype=torch.int32, device=dev)[
            None, None].expand(3, b, s)
    if cfg.encdec:
        out["src_embeds"] = torch.as_tensor(
            rng.standard_normal((b, SRC_LEN, cfg.d_model), dtype=np.float32),
            device=dev)
    return out


def serve(arch: str, *, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device: DeviceLike = None) -> dict:
    """LM token serving (prefill + greedy decode) for an LM arch, with
    parameters drawn on ``device`` from ``seed`` and prompts (and an
    encoder-decoder's source frames) drawn with numpy from ``seed``, in the
    reference's order.  Not the decomposition path: that is
    :func:`serve_cpd` here and ``repro_torch.serve``."""
    cfg = configs.get(arch)
    if smoke:
        cfg = configs.smoke_of(cfg)
    dev = resolve_device(device)
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                            dev)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len), dtype=np.int32)
    return generate(model, serve_batch(model, prompts, rng), gen=gen)


def cpd_config(workload: str, *, smoke: bool, rank: int, niters: int,
               policy: str, seed: int, reorder: str, cache: str | None,
               method: str):
    """The launcher's declarative description: one RunConfig, shared with
    ``python -m repro_torch serve``."""
    from repro_torch.api import (DataConfig, ExecConfig, MethodConfig,
                                 PlanConfig, RunConfig, require_capability)

    # the one capability gate (raises with the registry listing if unknown)
    spec = require_capability(method, "local")
    return RunConfig(
        data=DataConfig(dataset=CPALS_DATASET[workload],
                        scale=0.002 if smoke else 1.0, seed=seed,
                        reorder=reorder, cache=cache),
        plan=PlanConfig(policy=policy),
        method=MethodConfig(name=method, rank=rank, niters=niters, seed=seed),
        exec=ExecConfig(executor="local",
                        n_chunks=8 if spec.supports_streaming else None),
    )


def serve_cpd(workload: str, *, smoke: bool, batch: int, queries: int,
              rank: int = 16, niters: int = 10, policy: str = "auto",
              seed: int = 0, reorder: str = "identity",
              cache: str | None = None, method: str = "cp_als",
              device: DeviceLike = None) -> dict:
    """Decompose a paper workload under a per-mode plan, then serve batched
    reconstruction queries (``values_at``) from the factor model.

    A thin wrapper over :class:`repro_torch.api.Session` on the
    :func:`cpd_config` RunConfig: the plan report is printed, the synthetic
    replica is drawn before the timed ingest, and ingest and decompose
    seconds end in a device synchronisation.  ``cache`` is the ingest cache
    root (a warm relaunch builds no workspace); queries and factors stay in
    the tensor's original labels."""
    from repro_torch.api import Session

    cfg = cpd_config(workload, smoke=smoke, rank=rank, niters=niters,
                     policy=policy, seed=seed, reorder=reorder, cache=cache,
                     method=method)
    with Session.from_config(cfg, device=device) as sess:
        # materialize the synthetic replica OUTSIDE the timed window so
        # ingest_s measures ingestion (and shows the cache win)
        sess.load_tensor()
        sess.synchronize()
        t0 = time.perf_counter()
        ing = sess.ingest()
        sess.synchronize()
        t_ingest = time.perf_counter() - t0

        print(sess.plan_report())
        plan = sess.plan()
        plan_summary = plan.summary() if plan is not None \
            else "streaming:gather_scatter"
        t0 = time.perf_counter()
        dec = sess.fit()
        sess.synchronize()
        t_decomp = time.perf_counter() - t0

        bench = sess.serve_handle().benchmark(queries=queries, batch=batch,
                                              seed=seed)
    return {"fit": float(dec.fit), "decompose_s": t_decomp,
            "serve_s": bench["serve_s"], "plan": plan_summary,
            "method": method, "ingest_s": t_ingest,
            "cache_hit": ing.cache_hit, "qps": bench["qps"],
            "latency_ms": bench["latency_ms"], "decomp": dec}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=tuple(configs.ARCH_NAMES) + tuple(CPALS_DATASET),
                    help="cpals-<workload> = decomposition serving; LM arch "
                         "names = LM token serving")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--queries", type=int, default=2048,
                    help="cpals serving: total reconstruction queries")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--impl", default="auto",
                    help="cpals serving: planner policy (auto or impl name)")
    ap.add_argument("--method", default="cp_als",
                    help="cpals serving: decomposition method "
                    "(repro_torch.methods registry: cp_als/cp_nn_hals/"
                    "tucker_hooi/cp_als_streaming)")
    ap.add_argument("--reorder", default="identity",
                    help="cpals serving: ingest reordering "
                    "(identity/degree_sort/random_block)")
    ap.add_argument("--cache", default=None,
                    help="cpals serving: ingest cache root (warm relaunch "
                    "skips sort+stats)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' asks "
                    "for the CPU)")
    args = ap.parse_args(argv)
    if args.arch in CPALS_DATASET:
        out = serve_cpd(args.arch, smoke=args.smoke,
                        batch=args.batch, queries=args.queries,
                        rank=args.rank, niters=args.iters, policy=args.impl,
                        reorder=args.reorder, cache=args.cache,
                        method=args.method, device=args.device)
        print(f"[serve] method {out['method']}  plan {out['plan']}  "
              f"fit {out['fit']:.4f}  "
              f"ingest {out['ingest_s']:.2f}s"
              f"{' (cache hit)' if out['cache_hit'] else ''}  "
              f"decompose {out['decompose_s']:.2f}s  "
              f"serve {out['serve_s']:.2f}s ({out['qps']:,.0f} vals/s, "
              f"p50 {out['latency_ms']['p50']:.2f}ms "
              f"p99 {out['latency_ms']['p99']:.2f}ms)")
        return
    out = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen,
                device=args.device)
    print(f"[serve] prefill {out['prefill_s']:.2f}s  decode "
          f"{out['decode_s']:.2f}s  ({out['decode_tok_s']:,.0f} tok/s)")
    print(f"[serve] sample tokens: {out['tokens'][0][:12].tolist()}")


if __name__ == "__main__":
    main()
