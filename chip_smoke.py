#!/usr/bin/env python3
"""Drive the PyTorch port's CP-ALS, Tucker, ingest, HALS, checkpoint,
streaming, front-door, serving, distributed, launcher, LM serving (every LM
family), LM training and production-mesh paths on one CUDA card and check
them, then the dry-run's traced bounds against the card's times.

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel), print each kernel's registers, stack and
   spills as ptxas reports them, and read the card's name and power limit,
   printed at the end, beside the numbers.
2. K1, MTTKRP: on each mode of the full-size yelp tensor (paper Table I
   shape, drawn on the card from the seed) at rank 35, the kernel against
   its plain version, in float32 (rtol/atol 1e-4: atomics change the order
   of summation) and in bfloat16 (5e-2).  Times, median of CUDA-event-timed
   calls after warm-up, beside the least time the card could take, and the
   factor-row bytes the kernel gathers from L2 and their rate.
3. K2, SYRK: at the three factor shapes, against its plain version (rtol
   1e-4, atol 1e-3), and beside ``torch.matmul(a.T, a)`` as the library's
   yardstick (timed here only; the port never calls it), each timed two
   ways: the median of single calls (the kernel table's ``ms``) and the
   time per launch over 100 back-to-back calls between one pair of CUDA
   events; and the device time of their kernels, from torch.profiler.
   Then the steady-state time of one mode's epilogue (the work after its
   MTTKRP).
4. K3, MTTKRP on the linearized workspace: ``build_linearized`` of the
   full yelp tensor with sort mode 0 (its row field straddles the two
   32-bit words) and sort mode 1 (its row field lies in the high word),
   the host build timed.  On each sort mode the kernel against its plain
   version (float32 at 1e-4, bfloat16 at 5e-2) and against K1 on that
   mode's CSF (1e-4: the same function on another layout), timed beside
   its bound (12 B a stored entry, the gathered factors, the output) and
   its L2 gathers.  Then the off-sort kernel on every other mode of each
   sort mode (sort mode 1 puts mode 0's field across the words), held to
   the same plain version and K1 at the same limits, timed beside its
   bound, its L2 gathers and its atomic bytes (runs of equal rows x width
   x 4 B, each run ending where the row changes or a warp's range ends)
   and their rate.
5. The main path: ``repro_torch.methods.fit(t, 35, method="cp_als",
   impl="cuda", niters=20, timers=...)`` on yelp, with every launch count
   set to 0 just before and read just after: MTTKRP must launch 3 modes x
   20 iterations = 60 times, K3 and SYRK none (the driver keeps ``A.T @ A``
   as the reference's does).  Against the plain ``impl="segment"`` run from
   the same initial factors, its fit must agree within 1e-5, and lambda and
   each factor within a relative 3e-2: the kernel's float atomics reorder
   its sums, and the ALS solves against the Grams' hadamard product
   amplify that to a relative 1e-3 to 7e-3 already.
6. The linearized path: the same fit with ``impl="linearized_cuda"`` from
   the same state, the counts set to 0 just before: K3 launches 20 times
   (the sort mode, once an iteration) and the off-sort kernel 40 (modes 1
   and 2), K1 and SYRK none; held to ``segment`` as in phase 5.  Its
   routine times print beside the CSF fit's.
7. The measured planner: ``plan_decomposition(t, "auto", rank=35,
   calibrate=True, autotune=<temporary store>)`` prints each mode's
   measured ms per candidate and the winner; a second plan on the same
   store (its content key and stats pass timed apart) must be ``"measured-cached"`` on every mode with the same impls,
   3 store hits and no timing run; a 20-iteration fit with that plan is
   held to ``segment``'s fit within 1e-5.
8. The Gram entry point, SYRK's path: ``gram(a, impl="cuda")`` on the
   fitted factors, with the counts set to 0 just before; 3 launches, and
   the model's norm from those Grams within 1e-4 of the plain Grams'.
9. The TTMc kernels at Kronecker width: K1-TTMc on each mode's CSF of the
   yelp tensor, K3-TTMc on sort modes 0 and 1 and the off-sort TTMc on
   every other mode of each, at Tucker ranks (16, 16, 16) (W = 256), each
   against its plain version (float32 at 1e-4, bfloat16 at 5e-2), the
   linearized ones also against K1-TTMc on the same mode's CSF, timed
   beside their bounds and beside the factor rows each gathers from L2 and
   their rate (the off-sort one also beside its atomic bytes and their
   rate); then one thin SVD of mode 2's Y (75 000 x 256), the library call
   the fit makes after each TTMc.
10. The Tucker path: ``fit(t, (16, 16, 16), method="tucker_hooi",
   impl="cuda", niters=8, timers=...)`` with every count set to 0 just
   before: K1-TTMc launches 3 x 8 = 24 times, nothing else.  Held to the
   plain ``impl="segment"`` fit from the same orthonormal state, which
   must launch no kernel at all (so it stays independent of them): the fit
   within 1e-5, ``values_at`` on 100 000 stored coordinates within a
   relative 1e-3 (2-norm of the difference over that of the values), and
   each mode's subspace ``||U U^T - U' U'^T||_F / sqrt(R) <= 1e-3``
   (computed in float64 from U^T U, U'^T U' and U^T U').  The gap between
   sigma_R and sigma_{R+1} of each mode's final Y is printed beside it.
11. The linearized Tucker path: the same fit with
   ``impl="linearized_cuda"``: K3-TTMc launches 8 times (sort mode 0) and
   the off-sort TTMc 16 (modes 1 and 2), nothing else; held to
   ``segment`` as in phase 10.
12. The ingested path, in a temporary directory: ``write_tnsb`` of the
   yelp tensor and ``read_tnsb`` back (equal, bit for bit); a cold
   ``ingest(path, reorder="degree_sort", cache=...)`` (3 CSF builds and 1
   linearized build) and a warm one, which must be a cache hit and build
   nothing (the builds are counted at ``core.csf.build_csf`` and
   ``core.linearized.build_linearized``); ``ing.plan("auto", rank=35,
   calibrate=True)`` twice, the second from the cache's autotune store (3
   hits, no timing run).  Then ``fit(ing, 35, method="cp_nn_hals",
   niters=20)`` with ``impl="segment"``, ``"cuda"`` (60 K1 launches) and
   ``"linearized_cuda"`` (20 K3 + 40 off-sort), from one nonnegative
   state, the kernel fits held to ``segment``'s at the CP limits and every
   factor >= 0; ``fit(ing, 35, impl="cuda", niters=20)`` on the warm handle
   (no Sort), its factors back in the tensor's labels and held to phase
   5's ``segment`` fit; and a ``CheckpointManager`` resume: 10 iterations
   saved at each step, a fresh manager restores the newest onto the card,
   and a new fit resumes it to 20, held to the uninterrupted 20 at the CP
   limits.  Each step's seconds print beside the card's name and power
   limit.
13. Streaming: ``fit(path, 35, method="cp_als_streaming", niters=5)`` from
   the ``.tnsb`` (chunks of 2^20 entries moved to the card one at a time,
   ``decay=1``) against the batch ``segment`` fit from the same state:
   fits within 1e-3.
14. The front door, in phase 12's directory on its ``.tnsb`` and warm
   cache: ``repro_torch.api.cli.main(["fit", "--source", <tnsb>,
   "--reorder", "degree_sort", "--cache", <dir>, "--impl", "cuda",
   "--rank", "35", "--iters", "20", "--trace-dir", <dir>, ...])`` in this
   process, the counts set to 0 just before: K1 launches 60 times and
   nothing else, and its saved factors (``--out``) are held at the CP
   limits to a direct ``fit(ing, 35, impl="cuda", niters=20,
   generator=torch.Generator("cuda").manual_seed(0))``; the same with
   ``--impl linearized_cuda`` (20 K3 + 40 off-sort launches, held to the
   same direct fit); ``Session(RunConfig(method=MethodConfig("tucker_hooi",
   rank=16, niters=8), plan=PlanConfig("cuda")), tensor=ing)`` (24 K1-TTMc
   launches) held at the Tucker limits to the direct ``fit`` from the same
   generator; ``trace <dir>``: the trace holds ``stage.ingest``,
   ``stage.plan``, ``stage.fit``, ``sort``, ``iteration``, ``epilogue`` and
   60 ``mttkrp`` spans with ``impl="cuda"`` on modes 0-2, the routine table
   prints, and its ``mttkrp`` total lies within 20% of the same fit's
   ``timers["mttkrp"]`` (the spans wrap synchronised routines); the CLI fit
   with the trace off and on, both walls printed; a CP ``Session``'s
   fit (60 K1, held to the direct fit) under ``torch.profiler``, its
   kernels' device time over its wall printed as the card's busy share;
   that Session's ``serve_handle().benchmark(queries=1_000_000,
   batch=4096)`` (qps, p50, p99), and ``query`` on 100 000 stored
   coordinates within a relative
   1e-4 of a float64 reconstruction from the same factors; and
   ``python3 -m repro_torch --list-methods`` in a subprocess (exit 0).
   The CP Session stays for phase 15.
15. Serving, on phase 14's CP Session (tenants ``default`` and ``b``, two
   workers): ``decomp_server()``; ``values_at`` on the 100 000 stored
   coordinates within a relative 1e-4 of the float64 reconstruction, and
   ``top_k_for_user`` (k = 10) against a float64 score row; a
   ``TenantModel`` with one 4096 bucket, its graph replay equal to the
   eager ``ServeHandle.query`` bit for bit, then both timed over 200
   batches of 4096 from host numpy to host numpy, beside the model's graph
   called alone (pinned staging), the same graph driven with a pageable
   copy-in and ``.cpu()``, its replay alone, and the eager query on the
   card with one synchronisation at the end: host microseconds a batch and
   values/s; 8 client threads of mixed ``values_at`` (1-256
   stored coordinates, each answer within 1e-4 of float64) and ``top_k``
   (1-16 users of a pool, scores within 1e-4 of the float64 top 10) for 4
   s, ``b`` republished halfway: values/s, p50/p99 of
   ``serve.default.query_ms``, no failed future, no kernel launch, and at
   most one capture a bucket and a (bucket, k) on every model (the old
   ``b`` too); an LRU eviction under a budget of 2.5 models, the evicted
   model collected; ``ServeDaemon`` on an ephemeral port (``/healthz``,
   ``/v1/tenants``, ``/v1/top_k``, ``POST /v1/values_at``, ``/metrics``
   holding ``serve_qps``, ``POST /v1/shutdown``); and ``python3 -m
   repro_torch serve-daemon --source <tnsb> --reorder degree_sort --cache
   <dir> --rank 35 --port 0 --duration-s 30`` in a subprocess, its URL
   read from its ``# serving ... at`` line, one ``/v1/top_k``, then
   ``POST /v1/shutdown`` and exit 0.
16. The dist executor: ``Session(RunConfig(exec=ExecConfig(
   executor="dist", shard_c=...)), tensor=ing)`` with ``shard_c`` off and
   on, each on a one-rank NCCL group the Session starts and ends, R = 35,
   20 iterations, its plan restricted to ``gather_scatter``/``segment``,
   no kernel launch, held at the CP limits to a local ``segment`` Session
   fit from the same generator; plan, process-group, partition and
   iteration seconds beside the local fit's wall and its timed routine
   split; then the iteration body's local MTTKRPs on the rank's block as
   the fit prepares it (zero-valued padding dropped; ``scatter``;
   ``segment`` sorted once), and the ``segment`` reduction of the block as
   partitioned (padding kept) that sorts on every call, timed a mode,
   with the longest segment of each mode with and without the padding.
17. The decomposition launcher: ``repro_torch.launch.serve.serve_cpd(
   "cpals-yelp", smoke=False, rank=16, niters=10, policy="cuda",
   cache=<temporary directory>)`` (the full-scale replica drawn on the
   card, a cold ingest into the cache, the plan report, the fit, and
   ``ServeHandle.benchmark`` of 2^20 queries in batches of 4096), the
   counts set to 0 just before: K1 launches 3 modes x 10 = 30 times and
   nothing else; then ``policy="segment"`` on the same cache: a cache hit
   that builds no CSF and no linearized workspace, no launch, and a fit
   within 1e-5 of the ``cuda`` one (lambda and factors within a relative
   3e-2, as in phase 5).  Ingest, decompose and serve seconds, values/s and
   p50/p99 print for both.
18. LM serving at the full published width of llama3.2-3b (3.2 B
   parameters, drawn on the card from the seed): in float32, one decode
   step after a 64-token prefill (batch 2) against the forward pass over
   the 65 tokens, within the reference's decode limits (rtol 1e-2, atol
   2e-2); in bfloat16, layer 0's attention at prompt 4096, batch 1:
   ``_flash_attention`` against ``_sdpa`` under the causal mask within
   rtol 2e-2, atol 2e-2 (the two round the scores to bfloat16 at different
   steps, so outputs near 4 differ by a bfloat16 ulp), both timed; ``serve("llama3.2-3b", batch=4, gen=32)`` at prompt
   4096 (the flash path) and 512 (the sdpa path), twice each, every logit
   finite: prefill and decode seconds, decode tokens/s, the step time
   beside the HBM bound of reading every weight and the cache once, and the
   peak memory; 4 decode steps at prompt 512 under ``torch.profiler``:
   kernels a step and their device time against the wall; and ``smoke_of(llama3.2-3b)`` in float32 with the same
   parameters on the card and the CPU: logits within 1e-4 and the same
   greedy tokens.  This path reaches no hand-written kernel.
19. The other LM families (``lm-families``): in float32 at full width, one
   decode step against the forward (rtol 1e-2, atol 2e-2) for rwkv6-3b
   (batch 2, prompt 64) and recurrentgemma-9b (batch 1, prompt 2560, past
   its 2048-slot local ring); ``wkv_chunked`` (chunks of 128) against
   ``wkv_scan`` at rwkv6-3b's head shape (40 x 64, 512 positions) within
   1e-3 / 1e-4; then, each drawn on the card from the seed in bfloat16 and
   freed before the next, rwkv6-3b, recurrentgemma-9b (prompts 512 and
   2560), qwen2-vl-7b (embeddings, M-RoPE), seamless-m4t-large-v2 (16
   source frames) at full depth, dbrx-132b at 4 of its 40 layers and
   kimi-k2-1t-a32b at 2 of 61 (the dense layer and one MoE layer: the
   full models do not fit one card), served through ``serve_batch`` and
   ``generate`` at batch 4, prompt 512, 16 tokens: parameters and GB,
   the peak while drawing, prefill s, decode tokens/s, the step's ms
   beside its HBM bound (every weight and the cache read once), the peak,
   ``moe_drop_frac``; every logit finite and every token in range; a few
   decode steps under ``torch.profiler`` (kernels a step, busy share, the
   MoE dispatch's sorts and scatters); and each family's ``smoke_of``
   model in float32, card against CPU, within 1e-4 and the same greedy
   tokens.  No hand-written kernel here either.
20. LM training (``lm-train``), llama3.2-3b at full width: in float32
   (batch 1), a directional-derivative check of ``Model.loss``'s backward
   at sequences 256 and 4096 (the flash path, recomputed under remat):
   ``(L(p + e d) - L(p - e d)) / 2e`` against ``<grad L, d>`` with ``d =
   grad L / |grad L|`` and ``e |grad L| = 1e-2``, within a relative 1e-2;
   then in bfloat16 at train_4k's sequence length, 4 sequences of 4096 a
   step from ``TokenPipeline`` in 4 micro-batches, remat on:
   ``make_train_step`` with AdamW for 8 steps (seconds, tokens/s, loss,
   the share of the card's bfloat16 dense peak that ``6 N tokens`` would
   take, the peak GB; every loss finite, and the loss of the first step's
   batch, taken again after the 8 steps, below its first value), one
   step under ``torch.profiler`` (kernels, busy share, the kernels with the
   most device time), a step's forward, backward, accumulation and
   optimizer timed apart by CUDA events; 2 Adafactor steps, and 2 Adafactor steps with int8 gradient compression
   (peak GB, the compression ratio); every preset's ``smoke_of`` in float32,
   one AdamW step on the card and on the CPU from the same parameters
   (loss within 1e-5, every parameter within 1e-4); and ``train()`` at
   smoke width for 3 steps then resumed to 6 from its checkpoint, equal to
   an uninterrupted 6-step run.  Training reaches no hand-written kernel.
21. The production mesh (``lm-mesh``): a one-rank NCCL group and its
   (data=1, model=1) grid, ``rules_for(cfg)`` and the activation hook.
   llama3.2-3b at full width in bfloat16, first without the hook, then
   with its parameters placed (``place_model``) from the same weights:
   ``generate`` at batch 4, prompt 512, 16 greedy tokens (the same tokens;
   logits within rtol 1e-2, atol 2e-2), 4 decode steps under
   ``torch.profiler`` (kernels a step, busy share), and one AdamW step at
   1 x 4096 tokens from the same zero state (the placed state through
   ``place``): loss within a relative 1e-2, every parameter after it within
   2e-2; prefill s, decode ms a step, step s and peak GB each way, and
   their differences, the host cost of DTensor's dispatch.  Then
   dbrx-132b at phase 19's cut (4 of 40 layers), at capacity factor 8
   (nothing dropped) and at the preset's 1.25: layer 0's MoE FFN,
   ``moe_ffn_ep`` (its two one-rank ``all_to_all``s on NCCL) against the
   dense dispatch on the same input at the prefill's shape and a decode
   step's, in float32 within 1e-4 (rtol and atol) and in bfloat16 beside
   the dense dispatch's own spread from run to run; ``generate`` through
   ``moe_ffn_ep`` (every MoE layer of every step takes it; nothing
   dropped; finite logits), its logits on the dense dispatch's tokens
   beside that spread, and both dispatches' ``moe_drop_frac`` at 1.25.
   No hand-written kernel here either.
22. The dry-run (``repro_torch.launch.dryrun``), on the card's host, each
   process on a fake process group of its own: ``cpals-yelp``'s
   distributed iteration on the single-pod (16 x 16 = 256 ranks) and
   multi-pod (2 x 16 x 16 = 512) grids, llama3.2-3b ``train_4k``,
   dbrx-132b ``decode_32k`` (a step's one position takes the dense MoE
   dispatch) and ``prefill_32k`` (``moe_ffn_ep``'s two all-to-alls a
   layer) on the single-pod grid, all at once, within 150 s: each cell's
   dominant term,
   bound, ``peak_estimate_gib`` and collective mix, traced on ``meta`` and
   turned into time by the H100's constants (nothing of it measured on
   the card).  Then two bounds traced the same way on a one-rank grid
   (world 1), each held below the card's own time: llama3.2-3b's AdamW
   step at 1 x 4096 tokens against phase 21's step without the hook, and
   ``cpals-yelp``'s dist iteration (phase 16's local impls) against phase
   16's iteration; a bound above the measured time means a wrong count.
   It launches no kernel.
23. One JSON line of kernel numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

RANK = 35
NITERS = 20
TUCKER_RANKS = (16, 16, 16)
TUCKER_NITERS = 8
STREAM_NITERS = 5
SERVE_TENANTS = ("default", "b")
SERVE_WORKERS = 2
SERVE_CLIENTS = 8
SERVE_LOAD_S = 4.0
TOP_K = 10
LAUNCH_RANK = 16
LAUNCH_NITERS = 10
LAUNCH_BATCH = 4096
LAUNCH_QUERIES = 1 << 20
LM_ARCH = "llama3.2-3b"
LM_BATCH = 4
LM_GEN = 32
LM_PROFILE_STEPS = 4
# phase 19: each family in bfloat16 at its published width, the prompts it
# is served at, and the two MoE depth cuts one card's 80 GB forces
FAMILY_PROMPTS = (("rwkv6-3b", (512,)), ("recurrentgemma-9b", (512, 2560)),
                  ("qwen2-vl-7b", (512,)), ("seamless-m4t-large-v2", (512,)),
                  ("dbrx-132b", (512,)), ("kimi-k2-1t-a32b", (512,)))
FAMILY_LAYERS = {"dbrx-132b": 4, "kimi-k2-1t-a32b": 2}
FAMILY_BATCH = 4
FAMILY_GEN = 16
FAMILY_PROFILE_PROMPT = 512
# NVIDIA H100 SXM data sheet (dense, no sparsity) at the full 700 W limit
# phase 20: train_4k's sequence length, 4 sequences a step in 4 micro-batches
# (one sequence each: 51.4 GB of weights, gradients, AdamW moments and the
# float32 accumulator before activations; PERF.md §4)
TRAIN_BATCH = 4
TRAIN_SEQ = 4096
TRAIN_MICRO = 4
TRAIN_STEPS = 8
TRAIN_EXTRA_STEPS = 2
TRAIN_DD_SEQS = (256, 4096)
# phase 21: the mesh on one card, a (data=1, model=1) grid on one NCCL rank
MESH_BATCH = 4
MESH_PROMPT = 512
MESH_GEN = 16
MESH_TRAIN_SEQ = 4096
MESH_PROFILE_STEPS = 4
MESH_MOE_ARCH = "dbrx-132b"
MESH_NO_DROP_CF = 8.0
# phase 22: the dry-run's cells, each a subprocess on its own fake group,
# and the one-rank grids held to phases 21 and 16
DRYRUN_CELLS = (("cpals-yelp", None, "single"), ("cpals-yelp", None, "multi"),
                ("llama3.2-3b", "train_4k", "single"),
                ("dbrx-132b", "decode_32k", "single"),
                ("dbrx-132b", "prefill_32k", "single"))
DRYRUN_BUDGET_S = 150.0
DRYRUN_ONE_RANK = r"""
import json, sys
from repro_torch.dist.collectives import make_mesh
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ShapeConfig
out, arch, seq, impls = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
D.init_fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
D.run_cell(arch, f"train_1x{seq}", multi_pod=False, mesh=mesh,
           shape=ShapeConfig(f"train_1x{seq}", seq, 1, "train"),
           out_dir=out, tag="one_rank")
rl, counts, info = D.trace_cpals("cpals-yelp", mesh,
                                 local_impls=tuple(impls.split(",")))
print("CPALS " + json.dumps({"roofline": rl.to_json(),
                             "memory": counts["memory"],
                             "info": {k: info[k] for k in (
                                 "local_cap", "local_impls")}}))
"""
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for the work, and whether bytes or operations set
    it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def totals() -> dict[str, float]:
    """A kernel's times and bound summed over the calls the main path makes,
    and its largest error over every call checked."""
    return dict.fromkeys(("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
                          "max_abs_err"), 0.0)


def add_times(acc, ms: float, plain_ms: float, nbytes: float,
              ops_count: float) -> None:
    """Add one call's times and bound to a kernel's totals."""
    acc["ms"] += ms
    acc["plain_ms"] += plain_ms
    acc["bound_ms"] += bound(nbytes, ops_count)[0]
    acc["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
    acc["ops_ms"] += ops_count / FP32_FLOP_PER_S * 1e3


def kernel_entry(name: str, source: str, replaces: str, launches: int, acc,
                 **extra) -> dict:
    """One kernel's object of the ``{"kernels": ...}`` line."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, **extra, "launches": launches,
            "max_abs_err": acc["max_abs_err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                         else "operations"),
            "library_ms": acc.get("library_ms")}


def time_ms(torch, fn, *, warmup: int = 3, reps: int = 15) -> float:
    """Median of CUDA-event-timed calls of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_per_launch_ms(torch, fn, *, warmup: int = 3,
                       launches: int = 100) -> float:
    """Time of one call of ``fn`` over ``launches`` back-to-back calls
    between one pair of CUDA events, after ``warmup`` calls: the host's
    per-call work overlaps the card's, as in a loop of calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def device_us(torch, fn, *, calls: int = 20) -> float | None:
    """Device time of one call of ``fn`` in microseconds: its kernels'
    device time summed over ``calls`` calls traced by torch.profiler, over
    ``calls``; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total / calls if total > 0 else None


def gathered_bytes(ids, row_bytes) -> int:
    """Bytes of factor rows a row-segmented kernel gathers from L2 in one
    call, counted in 32-B sectors: each stored entry (padding included)
    reads the whole row of each other factor, the warp's lanes together, and
    the row of id ``i`` in a factor of ``b``-byte rows starts at byte
    ``i * b``, so it touches the sectors ``i * b // 32`` through
    ``(i * b + b - 1) // 32``.  ``ids``: per other factor, the (pnnz,) row
    ids the kernel reads; ``row_bytes``: that factor's row stride in
    bytes."""
    sectors = 0
    for i, b in zip(ids, row_bytes):
        first = i.long() * b
        sectors += int(((first + b - 1) // 32 - first // 32 + 1).sum())
    return 32 * sectors


def atomic_runs(torch, rows, segment: int) -> int:
    """Runs of equal rows the off-sort kernel adds to its output with
    atomics in one call: a run ends where the row changes or where a warp's
    range of ``segment`` stored entries ends.  ``rows``: the (pnnz,) target
    rows the kernel decodes, padding included."""
    new = torch.ones_like(rows, dtype=torch.bool)
    new[1:] = rows[1:] != rows[:-1]
    new[::segment] = True
    return int(new.sum())


def build_lines(log: str) -> list[tuple[str, int, int, int]]:
    """(mangled kernel name, registers, stack bytes, spill bytes) for each
    entry function of ptxas's ``-v`` report."""
    rows, name, stack, spill = [], "", 0, 0
    for line in log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            stack, spill = nums[0], nums[1] + nums[2]
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            rows.append((name, regs, stack, spill))
            name, stack, spill = "", 0, 0
    return rows


def demangle(names: list[str]) -> list[str]:
    """The kernels' names through one c++filt, each cut to its template;
    the mangled names where c++filt is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    if len(out) != len(names):
        return names
    return [o.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for o in out]


def max_err(torch, got, want, *, rtol: float, atol: float, what: str) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=what)
    return float((got - want).abs().max())


def rel_diffs(torch, got, want) -> tuple[float, list[float]]:
    """Largest relative difference of lambda, and the relative Frobenius
    difference of each factor, between two decompositions."""
    lmbda = float(((got.lmbda - want.lmbda).abs()
                   / want.lmbda.abs().clamp_min(1e-30)).max())
    return lmbda, [float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                   for a, b in zip(got.factors, want.factors)]


def subspace_gap(torch, u, v) -> float:
    """||U U^T - V V^T||_F / sqrt(R) from the R x R products alone (the
    n x n ones would not fit), in float64: the squared norm is
    ||U^T U||^2 + ||V^T V||^2 - 2 ||U^T V||^2 for any U, V."""
    u, v = u.double(), v.double()
    sq = (torch.linalg.norm(u.T @ u) ** 2 + torch.linalg.norm(v.T @ v) ** 2
          - 2 * torch.linalg.norm(u.T @ v) ** 2)
    return math.sqrt(max(0.0, float(sq)) / u.shape[1])


def front_door(torch, work: Path, path: Path, cache: Path, ing, t,
               sample_inds, card: str, none: dict, zero_counts, read_counts,
               check_against_segment, check_tucker):
    """Phase 14: the port's front door on phase 12's ``.tnsb`` and warm
    cache (see the module docstring).  Returns the phase's seconds and its
    fitted CP Session, which phase 15 serves."""
    import importlib

    from repro_torch.api import (MethodConfig, PlanConfig, RunConfig,
                                 ServeConfig, Session, cli)
    from repro_torch.methods import fit

    # the module: the package's ``cp_als`` attribute is the function
    cp_als_mod = importlib.import_module("repro_torch.methods.cp_als")
    from repro_torch.obs import read_trace, scoped_registry
    from repro_torch.obs.report import routine_breakdown

    start = time.perf_counter()
    base = ["fit", "--source", str(path), "--reorder", "degree_sort",
            "--cache", str(cache), "--rank", str(RANK), "--iters",
            str(NITERS)]

    def run_cli(argv: list[str]) -> tuple[str, float, dict[str, int]]:
        """``cli.main(argv)`` in this process, the launch counts set to 0
        just before and read just after: (its stdout, the host seconds,
        the counts).  A non-zero exit is a failure of the phase."""
        out = io.StringIO()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        text = out.getvalue()
        print("\n".join(f"[front] | {line}" for line in text.splitlines()))
        if rc != 0:
            raise AssertionError(f"python -m repro_torch {argv[0]} exited "
                                 f"{rc}")
        return text, seconds, counts

    def fit_wall(text: str) -> float:
        return float(re.search(r"^fit=\S+ wall=(\S+)s$", text, re.M)[1])

    def saved(npz: Path):
        """The factors a CLI fit saved with ``--out``, back on the card."""
        import numpy as np

        with np.load(npz) as z:
            order = sum(k.startswith("factor_") for k in z.files)
            return SimpleNamespace(
                fit=torch.tensor(z["fit"]),
                lmbda=torch.from_numpy(z["lmbda"]).cuda(),
                factors=tuple(torch.from_numpy(z[f"factor_{m}"]).cuda()
                              for m in range(order)))

    def cuda_generator():
        return torch.Generator("cuda").manual_seed(0)

    direct = fit(ing, RANK, impl="cuda", niters=NITERS,
                 generator=cuda_generator())

    # the traced CLI fit: the timers its auto_timers hands the driver are
    # kept, so the trace can be held to the same fit's timers
    timers_seen = []
    real_auto_timers = cp_als_mod.auto_timers

    def keep_timers(timers, tracer=None):
        out = real_auto_timers(timers, tracer)
        timers_seen.append(out[0])
        return out

    trace_dir = work / "trace"
    cp_als_mod.auto_timers = keep_timers
    try:
        with scoped_registry():
            text, cuda_s, counts = run_cli(
                base + ["--impl", "cuda", "--trace-dir", str(trace_dir),
                        "--out", str(work / "cuda.npz")])
    finally:
        cp_als_mod.auto_timers = real_auto_timers
    print(f"[front] cli fit --impl cuda --trace-dir: launches={counts} "
          f"host s={cuda_s:.4f} fit wall s={fit_wall(text):.2f} on {card}")
    if counts != dict(none, mttkrp=t.order * NITERS):
        raise AssertionError(f"cli fit --impl cuda launches {counts}, "
                             f"expected {t.order * NITERS} K1 and nothing "
                             "else")
    check_against_segment(saved(work / "cuda.npz"), "cli --impl cuda",
                          want=direct, against="direct fit", tag="front")

    text, lin_s, counts = run_cli(
        base + ["--impl", "linearized_cuda", "--out", str(work / "lin.npz")])
    print(f"[front] cli fit --impl linearized_cuda: launches={counts} host "
          f"s={lin_s:.4f} fit wall s={fit_wall(text):.2f} on {card}")
    if counts != dict(none, mttkrp_lin=NITERS,
                      mttkrp_off_sort=(t.order - 1) * NITERS):
        raise AssertionError(f"cli fit --impl linearized_cuda launches "
                             f"{counts}")
    check_against_segment(saved(work / "lin.npz"), "cli --impl "
                          "linearized_cuda", want=direct,
                          against="direct cuda fit", tag="front")

    # a Tucker Session on the warm handle, held to the direct fit
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tsess = Session(RunConfig(method=MethodConfig("tucker_hooi",
                                                  rank=TUCKER_RANKS[0],
                                                  niters=TUCKER_NITERS),
                              plan=PlanConfig("cuda")), tensor=ing)
    tdec = tsess.fit()
    torch.cuda.synchronize()
    tucker_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"[front] Session tucker_hooi cuda: launches={counts} "
          f"s={tucker_s:.4f} on {card}")
    if counts != dict(none, ttmc=t.order * TUCKER_NITERS):
        raise AssertionError(f"Session tucker_hooi launches {counts}")
    if (tuple(tdec.core.shape) != TUCKER_RANKS
            or not torch.isfinite(tdec.core).all()
            or any(tuple(a.shape) != (d, r) or not torch.isfinite(a).all()
                   for a, d, r in zip(tdec.factors, t.dims, TUCKER_RANKS))):
        raise AssertionError("Session tucker_hooi: a core or factor of the "
                             "wrong shape, or non-finite values")
    check_tucker(tdec, "Session tucker_hooi cuda",
                 want=fit(ing, TUCKER_RANKS[0], method="tucker_hooi",
                          impl="cuda",
                          niters=TUCKER_NITERS, generator=cuda_generator()),
                 against="direct fit", tag="front")
    del tsess, tdec

    # the trace: its spans, and the mttkrp row against the timers
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["trace", str(trace_dir)])
    print("\n".join(f"[front] | {line}" for line in
                    out.getvalue().splitlines()))
    if rc != 0:
        raise AssertionError(f"python -m repro_torch trace exited {rc}")
    events = read_trace(trace_dir / "trace.jsonl")
    names = {e["name"] for e in events}
    missing = {"stage.ingest", "stage.plan", "stage.fit", "sort",
               "iteration", "mttkrp", "epilogue"} - names
    mttkrp_spans = [e for e in events if e["name"] == "mttkrp"]
    span_modes = sorted({e["args"]["mode"] for e in mttkrp_spans})
    span_impls = sorted({e["args"]["impl"] for e in mttkrp_spans})
    if (missing or len(mttkrp_spans) != t.order * NITERS
            or span_modes != list(range(t.order)) or span_impls != ["cuda"]):
        raise AssertionError(f"trace: missing spans {missing}, "
                             f"{len(mttkrp_spans)} mttkrp spans on modes "
                             f"{span_modes} with impls {span_impls}")
    span_s = routine_breakdown(events)["routines"]["mttkrp"]["total_s"]
    timer_s = timers_seen[0]["mttkrp"]
    print(f"[front] trace mttkrp row s={span_s:.5f} timers['mttkrp'] "
          f"s={timer_s:.5f} ratio={span_s / timer_s:.4f} on {card}")
    if len(timers_seen) != 1 or abs(span_s - timer_s) > 0.2 * timer_s:
        raise AssertionError("the trace's mttkrp row is not within 20% of "
                             "the fit's timers")

    # the same CLI fit with the trace off, then on
    walls = {}
    for label, extra in (("off", []),
                         ("on", ["--trace-dir", str(work / "trace-2")])):
        text, host_s, counts = run_cli(base + ["--impl", "cuda", *extra])
        if counts != dict(none, mttkrp=t.order * NITERS):
            raise AssertionError(f"cli fit, trace {label}: launches {counts}")
        walls[label] = (host_s, fit_wall(text))
    print(f"[front] cli fit --impl cuda, trace off / on: host s "
          f"{walls['off'][0]:.4f} / {walls['on'][0]:.4f}, printed fit wall s "
          f"{walls['off'][1]:.2f} / {walls['on'][1]:.2f} on {card}")

    # serving: a CP Session's handle on the warm handle; its fit (plan +
    # 20 iterations) runs under torch.profiler, for the card's busy share
    from torch.profiler import ProfilerActivity, profile

    zero_counts()
    ssess = Session(RunConfig(method=MethodConfig(rank=RANK, niters=NITERS),
                              plan=PlanConfig("cuda"),
                              serve=ServeConfig(tenants=SERVE_TENANTS,
                                                workers=SERVE_WORKERS)),
                    tensor=ing)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        handle = ssess.serve_handle()
        torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    counts = read_counts()
    busy_s = sum(ev.device_time_total for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(f"[front] Session cp_als cuda fit under torch.profiler: wall s="
          f"{profiled_s:.4f}, kernels' device s={busy_s:.4f}, busy share="
          + (f"{busy_s / profiled_s:.3f}" if busy_s > 0 else "not measured")
          + f" on {card}")
    if counts != dict(none, mttkrp=t.order * NITERS):
        raise AssertionError(f"Session cp_als cuda launches {counts}")
    check_against_segment(handle.decomp, "Session cp_als cuda", want=direct,
                          against="direct fit", tag="front")
    bench = handle.benchmark(queries=1_000_000, batch=4096)
    lat = bench["latency_ms"]
    got = handle.query(sample_inds).double()
    dec = handle.decomp
    want = dec.lmbda.double()[None, :].expand(sample_inds.shape[0], -1)
    for m, a in enumerate(dec.factors):
        want = want * a.double()[sample_inds[:, m].long()]
    want = want.sum(dim=1)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    print(f"[front] ServeHandle.benchmark {bench['queries']} queries in "
          f"batches of 4096: qps={bench['qps']:.0f} serve_s="
          f"{bench['serve_s']:.4f} p50_ms={lat['p50']:.4f} p99_ms="
          f"{lat['p99']:.4f} ({lat['count']} batches); query of "
          f"{sample_inds.shape[0]} stored coordinates vs float64 rel="
          f"{rel:.3e} on {card}")
    if not (math.isfinite(bench["qps"]) and bench["qps"] > 0
            and math.isfinite(lat["p99"])):
        raise AssertionError(f"serve benchmark: {bench}")
    if not rel <= 1e-4:
        raise AssertionError(f"ServeHandle.query differs from the float64 "
                             f"reconstruction by {rel}")
    del handle, dec

    # the module entry point in a fresh interpreter
    src = Path(__file__).resolve().parent / "src"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "--list-methods"],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
        text=True, timeout=300)
    print(f"[front] python3 -m repro_torch --list-methods: exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0 or "cp_als" not in proc.stdout:
        raise AssertionError(f"python3 -m repro_torch --list-methods: "
                             f"{proc.returncode}\n{proc.stderr[-2000:]}")
    return time.perf_counter() - start, ssess


def serving(torch, path: Path, cache: Path, ssess, sample_inds, card: str,
            none: dict, zero_counts, read_counts) -> float:
    """Phase 15: serving phase 14's fitted CP Session (see the module
    docstring).  Returns the phase's seconds."""
    import gc
    import queue
    import threading
    import urllib.request
    import weakref

    import numpy as np

    from repro_torch.obs import scoped_registry
    from repro_torch.serve import ModelRegistry, ServeDaemon, TenantModel
    from repro_torch.serve.queries import resident_bytes

    start = time.perf_counter()
    zero_counts()
    srv = ssess.decomp_server()  # publishes the fit under both tenants
    handle = ssess.serve_handle()
    dec, dims = handle.decomp, handle.dims
    if sorted(srv.tenants()) != sorted(SERVE_TENANTS):
        raise AssertionError(f"decomp_server tenants {srv.tenants()}")

    # float64 references: the stored coordinates' values, and the score
    # rows of a pool of users
    lam64 = dec.lmbda.double()
    f64 = [a.double() for a in dec.factors]
    want = lam64[None, :].expand(sample_inds.shape[0], -1)
    for m, a in enumerate(f64):
        want = want * a[sample_inds[:, m].long()]
    want = want.sum(dim=1).cpu().numpy()
    coords = sample_inds.cpu().numpy().astype(np.int32)
    weights = lam64 * f64[2].sum(dim=0)
    pool = np.arange(64) * (dims[0] // 64)
    rows64 = (f64[0][torch.from_numpy(pool).cuda()] * weights) @ f64[1].T
    top64 = torch.topk(rows64, TOP_K, dim=1).values.cpu().numpy()
    rows64 = rows64.cpu().numpy()

    def rel(got, ref) -> float:
        return float(np.linalg.norm(got.astype(np.float64) - ref)
                     / np.linalg.norm(ref))

    got = srv.values_at("default", coords)
    vrel = rel(got, want)
    scores, items = srv.top_k_for_user("default", int(pool[1]), k=TOP_K)
    krel = max(rel(scores, top64[1]), rel(scores, rows64[1][items]))
    print(f"[serve] decomp_server tenants {sorted(srv.tenants())}: values_at "
          f"of {coords.shape[0]} stored coordinates vs float64 rel="
          f"{vrel:.3e}; top_k_for_user({pool[1]}, k={TOP_K}) scores vs the "
          f"float64 row rel={krel:.3e} on {card}")
    if not (vrel <= 1e-4 and krel <= 1e-4):
        raise AssertionError("served values or top-k scores differ from the "
                             "float64 reconstruction")

    # a graph-replayed values_at at 4096 against the eager ServeHandle.query
    reps, n = 200, 4096
    m4096 = TenantModel(dec, dims, buckets=(n,))
    batch = coords[:n]
    graph_vals = m4096.values_at(batch)
    eager_vals = handle.query(batch).cpu().numpy()
    if not np.array_equal(graph_vals, eager_vals):
        raise AssertionError("the graph replay differs from the eager query")
    dev_batch = torch.from_numpy(batch).cuda()
    # the model's graph called alone, the same graph driven with a pageable
    # copy in and a synchronised .cpu() out, and its replay alone (private
    # attributes: this is a measurement)
    graph = m4096._variants[("values_at", n)]

    def pageable():
        graph._in.copy_(torch.from_numpy(batch))
        graph._graph.replay()
        return graph._out[0].cpu().numpy()

    if not np.array_equal(pageable(), graph_vals):
        raise AssertionError("the pageable replay differs")
    timings = {}
    for label, fn in (
            ("TenantModel.values_at", lambda: m4096.values_at(batch)),
            ("its graph call (pinned staging, one sync)",
             lambda: graph(batch)),
            ("the same graph, pageable copy-in and .cpu()", pageable),
            ("its replay alone", lambda: (graph._graph.replay(),
                                          torch.cuda.synchronize())),
            ("eager query + .cpu() (host in, numpy out)",
             lambda: handle.query(batch).cpu()),
            ("eager query on the card, one sync at the end",
             lambda: handle.query(dev_batch))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        timings[label] = (time.perf_counter() - t0) / reps
    print(f"[serve] {n}-query batches, {reps} each, on {card}: " + "; ".join(
        f"{label}: {s * 1e6:.1f} us a batch, {n / s:.0f} values/s"
        for label, s in timings.items())
        + f"; captures {m4096.variant_keys}")
    del m4096, graph

    # 8 clients of mixed values_at / top_k, a republish of b halfway; each
    # client keeps its answers, checked after the load so the checks take
    # no time from it
    failures = []
    answers: list[list] = [[] for _ in range(SERVE_CLIENTS)]
    old_b = srv.registry.get("b").model
    stop = threading.Event()

    def client(seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            tenant = SERVE_TENANTS[int(rng.integers(0, 2))]
            try:
                if rng.random() < 0.7:
                    idx = rng.integers(0, coords.shape[0],
                                       int(rng.integers(1, 257)))
                    got = srv.submit_values_at(tenant, coords[idx]).result()
                    answers[seed].append(("values_at", idx, got))
                else:
                    pick = rng.integers(0, pool.size,
                                        int(rng.integers(1, 17)))
                    got, _ = srv.submit_top_k(tenant, pool[pick],
                                              k=TOP_K).result()
                    answers[seed].append(("top_k", pick, got))
            except Exception as exc:  # counted: the phase fails below
                failures.append(repr(exc))

    with scoped_registry() as reg:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(SERVE_LOAD_S / 2)
        srv.publish("b", dec, dims)
        time.sleep(SERVE_LOAD_S / 2)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        load_s = time.perf_counter() - t0
        lat = reg.histogram("serve.default.query_ms").summary()
        fill = reg.histogram("serve.batch_fill").summary()
        batches = srv.queue.batches_executed
    answered = {"values_at": 0, "top_k": 0}
    worst = {"values_at": 0.0, "top_k": 0.0}
    for kind, idx, got in (a for per in answers for a in per):
        ref = want[idx] if kind == "values_at" else top64[idx]
        answered[kind] += idx.size
        worst[kind] = max(worst[kind], rel(got, ref))
    print(f"[serve] {SERVE_CLIENTS} clients x {load_s:.2f} s, "
          f"{SERVE_WORKERS} workers, b republished halfway: "
          f"{answered['values_at']} values + {answered['top_k']} top-{TOP_K} "
          f"users = {sum(answered.values()) / load_s:.0f} answers/s "
          f"({answered['values_at'] / load_s:.0f} values/s); "
          f"serve.default.query_ms p50={lat['p50']:.4f} p99="
          f"{lat['p99']:.4f} ({lat['count']}); batch fill mean="
          f"{fill['mean']:.3f}; batches={batches}; failed futures="
          f"{len(failures)}; worst rel vs float64 {worst}; launches="
          f"{read_counts()} on {card}")
    if max(worst.values()) > 1e-4:
        raise AssertionError(f"served answers differ from float64: {worst}")
    models = {"default": srv.registry.get("default").model, "b (old)": old_b,
              "b (new)": srv.registry.get("b").model}
    for name, model in models.items():
        print(f"[serve] captures, {name}: {model.compile_count} "
              f"{model.variant_keys}")
        keys = model.variant_keys
        if len(keys) != len(set(keys)) or any(
                c > len(model.buckets) for c in model.compile_count.values()):
            raise AssertionError(f"{name}: more than one capture a bucket")
    if failures or read_counts() != none:
        raise AssertionError(f"failed futures {failures[:3]}, launches "
                             f"{read_counts()}")
    del models, old_b

    # an eviction under a budget of two models and a half
    one = resident_bytes(dec)
    reg = ModelRegistry(budget_bytes=2 * one + one // 2,
                        buckets=(64,))
    for tenant in ("x", "y"):
        reg.publish(tenant, dec, dims).model.values_at(coords[:64])
    gone = weakref.ref(reg.get("y").model)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reg.get("x")
    reg.publish("z", dec, dims)
    gc.collect()
    after = torch.cuda.memory_allocated()
    print(f"[serve] budget {2 * one + one // 2} B ({one} B a model): "
          f"resident {sorted(reg.tenants())}, evicted {reg.evicted}, the "
          f"evicted model collected={gone() is None}; card memory allocated "
          f"{before} -> {after} B")
    if reg.evicted != ["y"] or "y" in reg or gone() is not None:
        raise AssertionError("the LRU tenant was not evicted and freed")
    del reg

    # the daemon on an ephemeral port
    def http(url: str, data: bytes | None = None):
        with urllib.request.urlopen(url, data=data, timeout=60) as r:
            return r.status, r.read().decode()

    with scoped_registry():
        srv.values_at("default", coords[:8])  # a qps reading to scrape
        with ServeDaemon(srv, port=0) as daemon:
            status = {}
            status["healthz"], body = http(daemon.url + "/healthz")
            health = json.loads(body)
            status["tenants"], body = http(daemon.url + "/v1/tenants")
            tenants = json.loads(body)
            status["top_k"], body = http(
                f"{daemon.url}/v1/top_k?tenant=default&user={pool[2]}"
                f"&k={TOP_K}")
            topk = json.loads(body)
            status["values_at"], body = http(
                daemon.url + "/v1/values_at", json.dumps(
                    {"tenant": "b", "coords": coords[:3].tolist()}).encode())
            vals = np.asarray(json.loads(body)["values"])
            status["metrics"], prom = http(daemon.url + "/metrics")
            status["shutdown"], _ = http(daemon.url + "/v1/shutdown", b"")
            down = daemon.shutdown_requested.wait(timeout=10)
    print(f"[serve] ServeDaemon {daemon.url}: statuses {status}; healthz "
          f"{health['status']}, tenants {sorted(tenants)}, top_k items "
          f"{topk['items'][:3]}..., values_at rel="
          f"{rel(vals, want[:3]):.3e}, /metrics has serve_qps "
          f"{'serve_qps' in prom}, shutdown {down}")
    if (set(status.values()) != {200} or health["status"] != "serving"
            or sorted(tenants) != sorted(SERVE_TENANTS)
            or rel(np.asarray(topk["scores"]), top64[2]) > 1e-4
            or rel(vals, want[:3]) > 1e-4 or "serve_qps" not in prom
            or not down):
        raise AssertionError("the daemon's endpoints")

    # python -m repro_torch serve-daemon in a subprocess
    cmd = [sys.executable, "-m", "repro_torch", "serve-daemon", "--source",
           str(path), "--reorder", "degree_sort", "--cache", str(cache),
           "--rank", str(RANK), "--port", "0", "--duration-s", "30"]
    src = Path(__file__).resolve().parent / "src"
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=str(src)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
        daemon=True)
    reader.start()
    out, url = [], None
    try:
        while url is None:
            line = lines.get(timeout=300)
            if line is None:
                break
            out.append(line.rstrip())
            hit = re.match(r"# serving .* at (http://\S+)", line)
            url = hit[1] if hit else None
        up_s = time.perf_counter() - t0
        if url is None:
            raise AssertionError("serve-daemon printed no URL:\n"
                                 + "\n".join(out[-20:]))
        code, body = http(f"{url}/v1/top_k?user={pool[3]}&k={TOP_K}")
        items = json.loads(body)["items"]
        http(url + "/v1/shutdown", b"")
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    while not lines.empty():
        line = lines.get()
        if line is not None:
            out.append(line.rstrip())
    print("\n".join(f"[serve] | {line}" for line in out))
    print(f"[serve] {' '.join(cmd[1:4])} ...: serving after {up_s:.2f} s, "
          f"/v1/top_k {code} with {len(items)} items, exit {rc} after "
          f"{time.perf_counter() - t0:.2f} s on {card}")
    if code != 200 or len(items) != TOP_K or rc != 0:
        raise AssertionError(f"serve-daemon: top_k {code}, exit {rc}")
    return time.perf_counter() - start


def distributed(torch, ing, card: str, none: dict, zero_counts, read_counts,
                check_against_segment) -> tuple[float, dict]:
    """Phase 16: the dist executor at world size 1 on NCCL (see the module
    docstring).  Returns the phase's seconds and the ``shard_c=False``
    fit's iteration: its seconds (the fit's, partition aside, over
    ``NITERS``) and local impls."""
    import torch.distributed as dist

    import repro_torch.core.distributed as dist_mod

    dev = torch.device("cuda")
    from repro_torch.api import (ExecConfig, MethodConfig, PlanConfig,
                                 RunConfig, Session)
    from repro_torch.core.cpals import ROUTINES_FUSED
    from repro_torch.methods import fit

    start = time.perf_counter()

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    method = MethodConfig(rank=RANK, niters=NITERS)
    local = Session(RunConfig(method=method, plan=PlanConfig("segment")),
                    tensor=ing)
    ldec, local_s = sync_time(local.fit)
    timers: dict[str, float] = {}
    _, timed_s = sync_time(lambda: fit(
        ing, RANK, impl="segment", niters=NITERS, timers=timers,
        fused_epilogue=True, generator=local.method_generator()))
    print(f"[dist] local segment Session fit={float(ldec.fit):.7f} wall_s="
          f"{local_s:.4f}; timed: wall_s={timed_s:.4f} "
          + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                     for k in ROUTINES_FUSED) + f" on {card}")

    real_partition = dist_mod.partition_tensor
    iteration = {}
    for shard_c in (False, True):
        parts = []

        def timed_partition(*args, **kwargs):
            out, s = sync_time(lambda: real_partition(*args, **kwargs))
            parts.append(s)
            return out

        sess = Session(RunConfig(method=method, exec=ExecConfig(
            executor="dist", shard_c=shard_c)), tensor=ing)
        zero_counts()
        dist_mod.partition_tensor = timed_partition
        try:
            plan, plan_s = sync_time(sess.plan)
            mesh, mesh_s = sync_time(sess.mesh)
            ddec, fit_s = sync_time(sess.fit)
            backend, shape = dist.get_backend(), mesh.shape
        finally:
            dist_mod.partition_tensor = real_partition
            sess.close()
        counts = read_counts()
        loop_s = fit_s - sum(parts)
        print(f"[dist] executor=dist shard_c={shard_c} on {backend} "
              f"{shape}: plan {plan.summary()} s={plan_s:.4f}; process "
              f"group + grid s={mesh_s:.4f}; fit={float(ddec.fit):.7f} "
              f"wall_s={fit_s:.4f} (partition_s={sum(parts):.4f}, {NITERS} "
              f"iterations s={loop_s:.4f}); launches={counts}; group "
              f"ended={not dist.is_initialized()} on {card}")
        if (backend != "nccl" or shape != {"data": 1, "model": 1}
                or counts != none or dist.is_initialized()
                or not set(plan.impls) <= set(dist_mod.DIST_IMPLS)):
            raise AssertionError("the dist fit: backend, grid, launches or "
                                 "plan")
        check_against_segment(ddec, f"dist shard_c={shard_c}", want=ldec,
                              against="local segment", tag="dist")
        if not shard_c:
            # phase 22 holds the dry-run's one-rank bound to it
            iteration = {"s": loop_s / NITERS,
                         "impls": dist_mod._local_impls_of(plan)}

    # the iteration body's local MTTKRPs on the one rank's block, as the
    # fit prepares it (a segment mode's entries sorted once), and the
    # segment reduction that sorts on every call
    from repro_torch.dist import Mesh

    inds, vals, dims_p = real_partition(ing.tensor, 1, 1)
    inds, vals = torch.from_numpy(inds).cuda(), torch.from_numpy(vals).cuda()
    factors = tuple(a.contiguous() for a in ldec.factors)
    blocks = {}
    for impl in ("scatter", "segment"):
        block, prep_s = sync_time(lambda: dist_mod.local_block(
            inds, vals, Mesh(("data", "model"), (1, 1), device=dev),
            dims_p, (impl,) * 3))
        ms = [time_ms(torch, lambda: dist_mod._local_mttkrp(
            block.inds[m], block.vals[m], m, *factors, dims_p[m],
            impl=impl, lengths=block.lengths[m])) for m in range(3)]
        print(f"[dist] local MTTKRP impl={impl} (block prepared in "
              f"{prep_s:.4f} s) ms per mode "
              + " / ".join(f"{x:.4f}" for x in ms) + f" on {card}")
        blocks[impl] = block
    # the block as partitioned, its zero-valued padding kept (all of it on
    # the first rows), reduced by a segment sum that sorts on every call
    raw_inds, raw_vals = inds[0, 0], vals[0, 0]
    longest = [(int(torch.bincount(raw_inds[:, m]).max()),
                int(blocks["segment"].lengths[m].max())) for m in range(3)]
    ms = [time_ms(torch, lambda: dist_mod._local_mttkrp(
        raw_inds, raw_vals, m, *factors, dims_p[m], impl="segment"))
        for m in range(3)]
    print(f"[dist] local MTTKRP impl=segment on the block as partitioned "
          f"({raw_vals.shape[0]} entries, "
          f"{blocks['segment'].vals[0].shape[0]} of them stored), sorted on "
          f"every call, ms per mode " + " / ".join(f"{x:.4f}" for x in ms)
          + "; longest segment per mode, padded / prepared: "
          + ", ".join(f"{a} / {b}" for a, b in longest) + f" on {card}")
    local.close()
    return time.perf_counter() - start, iteration


def launcher(torch, dev, card: str, none: dict, zero_counts, read_counts,
             check_against_segment) -> float:
    """Phase 17: the decomposition launcher, ``serve_cpd`` on full-scale
    yelp (see the module docstring).  Returns the phase's seconds."""
    import repro_torch.core.csf as csf_mod
    import repro_torch.core.linearized as lin_mod
    from repro_torch.launch.serve import serve_cpd

    start = time.perf_counter()
    builds = {"build_csf": 0, "build_linearized": 0}
    real_builds = {"build_csf": csf_mod.build_csf,
                   "build_linearized": lin_mod.build_linearized}

    def counted_build(name):
        def build(*a, **k):
            builds[name] += 1
            return real_builds[name](*a, **k)
        return build

    outs = {}
    with tempfile.TemporaryDirectory(prefix="launch-") as cache:
        csf_mod.build_csf = counted_build("build_csf")
        lin_mod.build_linearized = counted_build("build_linearized")
        try:
            for policy in ("cuda", "segment"):
                builds.update(dict.fromkeys(builds, 0))
                zero_counts()
                t0 = time.perf_counter()
                out = serve_cpd("cpals-yelp", smoke=False,
                                batch=LAUNCH_BATCH, queries=LAUNCH_QUERIES,
                                rank=LAUNCH_RANK, niters=LAUNCH_NITERS,
                                policy=policy, cache=cache, device=dev)
                wall = time.perf_counter() - t0
                outs[policy] = (out, read_counts(), dict(builds))
                lat = out["latency_ms"]
                print(f"[launch] serve_cpd policy={policy} plan "
                      f"{out['plan']} fit={out['fit']:.7f} ingest_s="
                      f"{out['ingest_s']:.4f} (cache_hit={out['cache_hit']},"
                      f" builds {builds}) decompose_s="
                      f"{out['decompose_s']:.4f} serve_s={out['serve_s']:.4f}"
                      f" ({out['qps']:.0f} values/s over {LAUNCH_QUERIES} "
                      f"queries in batches of {LAUNCH_BATCH}, p50 "
                      f"{lat['p50']:.4f} ms p99 {lat['p99']:.4f} ms) "
                      f"wall_s={wall:.4f} launches={read_counts()} on {card}")
        finally:
            csf_mod.build_csf = real_builds["build_csf"]
            lin_mod.build_linearized = real_builds["build_linearized"]
    (kout, kcounts, _), (sout, scounts, sbuilds) = outs["cuda"], outs["segment"]
    if kcounts != dict(none, mttkrp=3 * LAUNCH_NITERS) or scounts != none:
        raise AssertionError(f"serve_cpd launches: cuda {kcounts}, segment "
                             f"{scounts}")
    if kout["cache_hit"] or not sout["cache_hit"] or any(sbuilds.values()):
        raise AssertionError(f"serve_cpd ingest cache: cold hit "
                             f"{kout['cache_hit']}, warm hit "
                             f"{sout['cache_hit']}, warm builds {sbuilds}")
    check_against_segment(kout["decomp"], "serve_cpd policy=cuda",
                          want=sout["decomp"], tag="launch",
                          against="serve_cpd policy=segment")
    return time.perf_counter() - start


def synced(torch, fn):
    """``fn()`` between two device synchronisations: (result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def f32_decode_check(torch, dev, card: str, cfg, batch: int, prompt: int,
                     seed: int, tag: str):
    """``cfg`` in float32, drawn on the card from ``seed``: one decode step
    after a prefill of ``prompt`` against the forward over prompt + 1
    positions, within the reference's decode limits (rtol 1e-2, atol
    2e-2).  Returns the model."""
    import dataclasses

    import numpy as np

    from repro_torch.models import Model

    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    model, draw_s = synced(torch, lambda: Model(cfg).init(
        torch.Generator(device=dev).manual_seed(seed), dev))
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt + 1),
                                       dtype=np.int32), device=dev)
    with torch.no_grad():
        full, fwd_s = synced(torch, lambda: model({"tokens": tok})[0][
            :, -1])
    cache = model.init_cache(batch, prompt + 1)
    _, pre_s = synced(torch, lambda: model.prefill(
        {"tokens": tok[:, :prompt]}, cache))
    (got, _), dec_s = synced(torch, lambda: model.decode_step(
        tok[:, prompt:], cache, prompt))
    err = max_err(torch, got[:, 0], full, rtol=1e-2, atol=2e-2,
                  what=f"{cfg.name} decode step vs forward (float32, full "
                  f"width)")
    print(f"[{tag}] {cfg.name} float32 at full width ({nbytes / 1e9:.3f} GB "
          f"drawn on the card in {draw_s:.4f} s), batch {batch}, prompt "
          f"{prompt} + 1: decode vs forward max |diff| {err:.3e} (limits "
          f"rtol 1e-2, atol 2e-2); forward over {prompt + 1} tokens "
          f"{fwd_s:.4f} s, prefill {pre_s:.4f} s, decode step {dec_s:.4f} s "
          f"on {card}")
    return model


def smoke_card_vs_cpu(torch, dev, card: str, arch: str, seed: int,
                      tag: str) -> None:
    """``smoke_of(arch)`` in float32 with the same parameters on the card
    and the CPU, served through ``serve_batch`` and ``generate`` (prompt
    12, 8 tokens): logits within 1e-4 and the same greedy tokens."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import generate, serve_batch
    from repro_torch.models import Model

    scfg = configs.smoke_of(configs.get(arch))
    cpu = Model(scfg).init(torch.Generator().manual_seed(seed), "cpu")
    on_card = Model(scfg)
    on_card.load_state_dict({k: v.to(dev) for k, v in
                             cpu.state_dict().items()}, assign=True)
    ids = np.random.default_rng(seed).integers(0, scfg.vocab, (2, 12),
                                               dtype=np.int32)
    want = generate(cpu, serve_batch(cpu, ids,
                                     np.random.default_rng(seed + 1)), gen=8)
    got = generate(on_card, serve_batch(on_card, ids,
                                        np.random.default_rng(seed + 1)),
                   gen=8)
    err = max_err(torch, got["logits"].cpu(), want["logits"], rtol=1e-4,
                  atol=1e-4, what=f"{scfg.name} logits, card vs CPU")
    same = bool((got["tokens"] == want["tokens"]).all())
    print(f"[{tag}] {scfg.name} float32 prompt 12 gen 8: card vs CPU logits "
          f"max |diff| {err:.3e} (limits rtol 1e-4, atol 1e-4), greedy "
          f"tokens equal={same} on {card}")
    if not same:
        raise AssertionError(f"{scfg.name}: greedy tokens differ between the "
                             f"card and the CPU")


# the MoE dispatch's kernels, by name: the expert sort, the capacity
# search, the gathers into the buffer and the scatter back
DISPATCH_KERNELS = re.compile(r"sort|Sort|search|index|scatter|gather")


def profiled(torch, fn, calls: int, *, cpu: bool = True) -> dict:
    """``fn(i)`` for i < ``calls`` under torch.profiler: kernels a call,
    their device ms a call against the wall's, the MoE dispatch's share
    (kernels and device ms a call), and the kernels with the most device
    time (name, count, ms over the calls).  ``cpu=False`` traces the card
    alone: a training step's 70 000 kernels and their CPU ops take the
    profiler over a minute to process, the kernels alone about 20 s."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    dispatch = [ev for ev in kernels if DISPATCH_KERNELS.search(ev.key)]
    top = sorted(kernels, key=lambda ev: -ev.device_time_total)[:6]
    return {"top": [(ev.key, ev.count, ev.device_time_total / 1e3)
                    for ev in top],"kernels": sum(ev.count for ev in kernels) / calls,
            "device_ms": sum(ev.device_time_total for ev in kernels)
            / 1e3 / calls,
            "wall_ms": wall * 1e3 / calls,
            "dispatch": sum(ev.count for ev in dispatch) / calls,
            "dispatch_ms": sum(ev.device_time_total for ev in dispatch)
            / 1e3 / calls}


def lm_serving(torch, dev, card: str, seed: int) -> float:
    """Phase 18: LM serving at the full width of llama3.2-3b (see the module
    docstring).  Returns the phase's seconds."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.params import tree_map

    start = time.perf_counter()
    cfg = configs.get(LM_ARCH)

    # 18.2 first: decode against forward in float32 at full width
    torch.cuda.reset_peak_memory_stats()
    model = f32_decode_check(torch, dev, card, cfg, 2, 64, seed, "lm")

    # 18.1: one layer's attention at prompt 4096, batch 1, bfloat16
    layer = tree_map(lambda a: a[0].to(cfg.cdtype),
                     model.params()["stack"])["b0"]
    del model
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        x = torch.randn((1, 4096, cfg.d_model), generator=g, device=dev
                        ).to(cfg.cdtype)
        h = L.apply_norm(layer["n1"], cfg, x)
        q = torch.einsum("bsd,dhk->bshk", h, layer["attn"]["wq"])
        k = torch.einsum("bsd,dnk->bsnk", h, layer["attn"]["wk"])
        v = torch.einsum("bsd,dnk->bsnk", h, layer["attn"]["wv"])
        positions = torch.arange(4096, device=dev)[None]
        q, k = L.apply_rope(cfg, q, k, positions)
        mask = L._train_mask("causal", 4096, 0, dev)[None, None, None]
        flash = L._flash_attention(cfg, q, k, v, "causal")
        sdpa = L._sdpa(cfg, q, k, v, mask)
        err = max_err(torch, flash, sdpa, rtol=2e-2, atol=2e-2,
                      what="flash vs sdpa (bfloat16, prompt 4096)")
        flash_ms = time_ms(torch, lambda: L._flash_attention(
            cfg, q, k, v, "causal"), warmup=1, reps=5)
        sdpa_ms = time_ms(torch, lambda: L._sdpa(cfg, q, k, v, mask),
                          warmup=1, reps=5)
    print(f"[lm] one layer's attention, batch 1, prompt 4096, bfloat16: "
          f"flash vs sdpa max |diff| {err:.3e} (limits rtol 2e-2, atol "
          f"2e-2: one bfloat16 ulp near 4 is 3.1e-2); flash "
          f"{flash_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms on {card}")
    del layer, x, h, q, k, v, mask, flash, sdpa
    torch.cuda.empty_cache()

    # 18.3: serve in the config's bfloat16, the flash then the sdpa path
    kv_bytes_tok = (cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
                    * cfg.cdtype.itemsize)
    param_bytes = cfg.param_count() * cfg.pdtype.itemsize
    for prompt in (4096, 512):
        for run in ("first", "second"):
            torch.cuda.reset_peak_memory_stats()
            out, wall = synced(torch, lambda: serve(
                LM_ARCH, smoke=False, batch=LM_BATCH, prompt_len=prompt,
                gen=LM_GEN, seed=seed, device=dev))
            finite = bool(torch.isfinite(out["logits"]).all())
            step_ms = out["decode_s"] / (LM_GEN - 1) * 1e3
            # least decode step: every weight and the cache read once
            bound_ms = ((param_bytes + LM_BATCH * (prompt + LM_GEN)
                         * kv_bytes_tok) / HBM_BYTES_PER_S * 1e3)
            print(f"[lm] serve {LM_ARCH} bfloat16 batch {LM_BATCH} prompt "
                  f"{prompt} gen {LM_GEN} ({run} call): prefill_s="
                  f"{out['prefill_s']:.4f} decode_s={out['decode_s']:.4f} "
                  f"({out['decode_tok_s']:.1f} tokens/s, {step_ms:.3f} ms a "
                  f"step, HBM bound {bound_ms:.3f} ms) wall_s={wall:.4f} "
                  f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                  f"finite={finite} on {card}")
            if not finite or out["tokens"].shape != (LM_BATCH, LM_GEN):
                raise AssertionError(f"serve prompt {prompt}: non-finite "
                                     f"logits or tokens of shape "
                                     f"{out['tokens'].shape}")
            del out
            torch.cuda.empty_cache()

    # where a decode step's time goes: its kernels' device time against its
    # wall, and how many it launches (torch.profiler over a few steps)
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, 512),
                                           dtype=np.int32), device=dev)
    cache = model.init_cache(LM_BATCH, 512 + LM_PROFILE_STEPS + 1)
    model.prefill({"tokens": prompts}, cache)
    model.decode_step(prompts[:, -1:], cache, 512)
    prof = profiled(torch, lambda i: model.decode_step(
        prompts[:, -1:], cache, 513 + i), LM_PROFILE_STEPS)
    print(f"[lm] decode step under torch.profiler ({LM_PROFILE_STEPS} steps, "
          f"batch {LM_BATCH}, cache {512 + LM_PROFILE_STEPS + 1}): "
          f"{prof['kernels']:.0f} kernels a step, device "
          f"{prof['device_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall a step "
          f"(busy share {prof['device_ms'] / prof['wall_ms']:.3f}) on {card}")
    del model, cache, prompts
    torch.cuda.empty_cache()

    # 18.4: smoke_of in float32, the same parameters on the card and the CPU
    smoke_card_vs_cpu(torch, dev, card, LM_ARCH, seed, "lm")
    return time.perf_counter() - start


def lm_families(torch, dev, card: str, seed: int) -> float:
    """Phase 19: the six other LM families served on the card (see the
    module docstring).  Returns the phase's seconds."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import generate, serve_batch
    from repro_torch.models import Model
    from repro_torch.models.rwkv import wkv_chunked, wkv_scan

    start = time.perf_counter()

    def cut(arch: str):
        cfg = configs.get(arch)
        layers = FAMILY_LAYERS.get(arch)
        return cfg if layers is None else dataclasses.replace(
            cfg, num_layers=layers)

    # 19.1: float32 decode against forward at full width
    for arch, batch, prompt in (("rwkv6-3b", 2, 64),
                                ("recurrentgemma-9b", 1, 2560)):
        f32_decode_check(torch, dev, card, cut(arch), batch, prompt, seed,
                         "families")
        torch.cuda.empty_cache()

    # 19.2: the chunked WKV against the scan at rwkv6-3b's head shape
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (0.5 * torch.randn((1, 512, 40, 64), generator=g, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn((1, 512, 40, 64),
                                               generator=g, device=dev)))
    u = 0.5 * torch.randn((40, 64), generator=g, device=dev)
    (so, ss), scan_s = synced(torch, lambda: wkv_scan(r, k, v, w, u))
    (co, cs), chunk_s = synced(torch, lambda: wkv_chunked(
        r, k, v, w, u, chunk=128))
    err = max(max_err(torch, co, so, rtol=1e-3, atol=1e-4,
                      what="wkv_chunked vs wkv_scan, output"),
              max_err(torch, cs, ss, rtol=1e-3, atol=1e-4,
                      what="wkv_chunked vs wkv_scan, state"))
    print(f"[families] wkv_chunked (chunk 128) vs wkv_scan, batch 1, 512 "
          f"positions, 40 heads x 64, float32: max |diff| {err:.3e} (limits "
          f"rtol 1e-3, atol 1e-4); scan {scan_s:.4f} s, chunked "
          f"{chunk_s:.4f} s on {card}")
    del r, k, v, w, u, so, ss, co, cs
    torch.cuda.empty_cache()

    # 19.3: each family in bfloat16 at its published width, served
    for arch, prompts in FAMILY_PROMPTS:
        cfg = cut(arch)
        torch.cuda.reset_peak_memory_stats()
        model, draw_s = synced(torch, lambda: Model(cfg).init(
            torch.Generator(device=dev).manual_seed(seed), dev))
        draw_gb = torch.cuda.max_memory_allocated() / 1e9
        n = sum(p.numel() for p in model.parameters())
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        depth = ("full" if arch not in FAMILY_LAYERS else
                 f"{cfg.num_layers} of {configs.get(arch).num_layers} layers")
        print(f"[families] {arch} bfloat16, {depth}: {n} parameters "
              f"({nbytes / 1e9:.3f} GB) drawn in {draw_s:.4f} s, peak "
              f"{draw_gb:.2f} GB while drawing on {card}")
        rng = np.random.default_rng(seed)
        for prompt in prompts:
            torch.cuda.reset_peak_memory_stats()
            ids = rng.integers(0, cfg.vocab, (FAMILY_BATCH, prompt),
                               dtype=np.int32)
            batch = serve_batch(model, ids, rng)
            out, wall = synced(torch, lambda: generate(
                model, batch, gen=FAMILY_GEN))
            logits, toks = out["logits"], out["tokens"]
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} prompt {prompt}: non-finite "
                                     f"logits")
            if toks.shape != (FAMILY_BATCH, FAMILY_GEN) or not (
                    (toks >= 0) & (toks < cfg.vocab)).all():
                raise AssertionError(f"{arch} prompt {prompt}: tokens out "
                                     f"of range or of shape {toks.shape}")
            cache = model.init_cache(
                FAMILY_BATCH, prompt + FAMILY_GEN,
                src_len=batch["src_embeds"].shape[1] if cfg.encdec else 0)
            cache_bytes = sum(t.numel() * t.element_size()
                              for t in _leaves(cache))
            del cache
            step_ms = out["decode_s"] / (FAMILY_GEN - 1) * 1e3
            bound_ms = (nbytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
            moe = ""
            if cfg.moe:
                moe = (f" moe_drop_frac="
                       f"{float(out['metrics']['moe_drop_frac']):.4f}")
            print(f"[families] serve {arch} batch {FAMILY_BATCH} prompt "
                  f"{prompt} gen {FAMILY_GEN}: prefill_s="
                  f"{out['prefill_s']:.4f} decode_s={out['decode_s']:.4f} "
                  f"({out['decode_tok_s']:.1f} tokens/s, {step_ms:.3f} ms a "
                  f"step, HBM bound {bound_ms:.3f} ms: {nbytes / 1e9:.3f} GB "
                  f"of weights + {cache_bytes / 1e9:.3f} GB of cache) "
                  f"wall_s={wall:.4f} peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
                  f"{moe} on {card}")
            if prompt == FAMILY_PROFILE_PROMPT:
                _profile_family(torch, model, batch, card, arch, prompt)
            del out, logits, batch
        del model
        torch.cuda.empty_cache()

    # 19.4: each family's smoke model in float32, card against CPU
    for arch, _ in FAMILY_PROMPTS:
        smoke_card_vs_cpu(torch, dev, card, arch, seed, "families")
    return time.perf_counter() - start


def _loss_and_grads(model, batch: dict):
    """``model.loss(batch)`` and its backward, the gradients left in
    ``.grad``; returns the loss as a float."""
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    return loss.item()


def directional_check(torch, model, batch: dict, card: str) -> None:
    """``Model.loss``'s backward against a central difference along the
    gradient: ``(L(p + e d) - L(p - e d)) / 2e`` with ``d = g / |g|`` is
    ``|g|`` within a relative 1e-2, ``e |g| = 1e-2`` (float32)."""
    seq = batch["labels"].shape[1]
    loss, bwd_s = synced(torch, lambda: _loss_and_grads(model, batch))
    params = list(model.parameters())
    gnorm = math.sqrt(sum(float(torch.sum(p.grad.double() ** 2))
                          for p in params))
    eps = 1e-2 / gnorm

    def shifted(scale):
        with torch.no_grad():
            for p in params:
                p.add_(p.grad, alpha=scale * eps / gnorm)
            return float(model.loss(batch)[0])

    up = shifted(1.0)
    down = shifted(-2.0)
    shifted(1.0)
    model.zero_grad(set_to_none=True)
    fd = (up - down) / (2 * eps)
    rel = abs(fd - gnorm) / gnorm
    print(f"[train] {model.cfg.name} float32 at full width, batch 1, "
          f"sequence {seq}: loss {loss:.6f}, forward + backward "
          f"{bwd_s:.4f} s; |grad| {gnorm:.6e}, central difference along "
          f"grad/|grad| (e = {eps:.3e}) {fd:.6e}: relative error {rel:.3e} "
          f"(limit 1e-2) on {card}")
    if not rel <= 1e-2:
        raise AssertionError(f"directional derivative at sequence {seq}: "
                             f"relative error {rel:.3e} > 1e-2")


def _event_ms(torch, fn):
    """``fn()`` between two CUDA events: (its result, the ms between them
    on the card)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _phase_split(torch, model, opt, state: dict, batch: dict,
                 step: int) -> dict:
    """Card ms of one train step's parts (CUDA events around each, the
    card synchronised between them), as ``make_train_step`` runs them: per
    micro-batch the forward (the loss) and the backward, the float32
    accumulation of ``g / m``, then the optimizer's update (clip +
    AdamW)."""
    from repro_torch.launch.steps import _split_micro
    from repro_torch.models.params import tree_map, tree_walk

    params = model.params()
    split = dict.fromkeys(("forward", "backward", "accumulate", "optimizer"),
                          0.0)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)

    def accumulate():
        for a, p in tree_walk(acc, params):
            a.add_(p.grad.float() / TRAIN_MICRO)
            p.grad = None

    micro = _split_micro(batch, TRAIN_MICRO)
    for i in range(TRAIN_MICRO):
        (loss, _), ms = _event_ms(torch, lambda: model.loss(
            {k: v[i] for k, v in micro.items()}))
        split["forward"] += ms
        split["backward"] += _event_ms(torch, loss.backward)[1]
        del loss
        split["accumulate"] += _event_ms(torch, accumulate)[1]
    split["optimizer"] += _event_ms(torch, lambda: opt.update(
        acc, state, params, step))[1]
    return split


def _smoke_train_card_vs_cpu(torch, dev, card: str, seed: int) -> None:
    """Every preset's ``smoke_of`` in float32: one AdamW train step (batch
    4, 32 positions) from the same parameters on the card and the CPU:
    the loss within 1e-5 and every updated parameter within 1e-4."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    for arch in configs.ARCH_NAMES:
        scfg = configs.smoke_of(configs.get(arch))
        cpu = Model(scfg).init(torch.Generator().manual_seed(seed), "cpu")
        on_card = Model(scfg)
        on_card.load_state_dict({k: v.to(dev, copy=True) for k, v in
                                 cpu.state_dict().items()}, assign=True)
        batch = TokenPipeline(scfg, 4, 32, seed, device="cpu").batch_at(0)
        losses = []
        for m in (cpu, on_card):
            opt = adamw(lr=1e-3)
            _, met = make_train_step(m, opt)(
                opt.init(m.params()),
                {k: v.to(m.device) for k, v in batch.items()}, 0)
            losses.append(float(met["loss"]))
        want = cpu.state_dict()
        perr = max(float((p.cpu() - want[k]).abs().max())
                   for k, p in on_card.state_dict().items())
        lerr = abs(losses[1] - losses[0])
        print(f"[train] {scfg.name} float32 AdamW step, batch 4 x 32: card "
              f"vs CPU loss {lerr:.3e} (limit 1e-5), parameters max |diff| "
              f"{perr:.3e} (limit 1e-4) on {card}")
        if not (lerr <= 1e-5 and perr <= 1e-4):
            raise AssertionError(f"{scfg.name}: the card's train step "
                                 f"differs from the CPU's")


def _resume_on_card(torch, dev, card: str, seed: int) -> None:
    """``train()`` at smoke width on the card: 3 steps, then resumed to 6
    from the checkpoint, against an uninterrupted 6-step run."""
    import numpy as np

    from repro_torch.launch.train import train

    kw = dict(smoke=True, batch=4, seq=64, seed=seed, log_every=100,
              device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            whole = train(LM_ARCH, steps=6, ckpt_dir=f"{tmp}/whole", **kw)
            train(LM_ARCH, steps=3, ckpt_dir=f"{tmp}/split", **kw)
            split = train(LM_ARCH, steps=6, ckpt_dir=f"{tmp}/split", **kw)
        arrays = []
        for run in ("whole", "split"):
            with np.load(Path(tmp) / run / "step_00000006" /
                         "shard0.npz") as data:
                arrays.append([data[f"a{i}"] for i in range(len(data.files))])
    lerr = max(abs(a - b) for a, b in zip(split["losses"],
                                          whole["losses"][3:]))
    perr = max(float(np.abs(a - b).max()) for a, b in zip(*arrays))
    resumed = "[train] resumed from step 3" in out.getvalue()
    print(f"[train] train() smoke {LM_ARCH}, 3 steps then resumed to 6 "
          f"(resumed={resumed}) vs 6 steps: losses max |diff| {lerr:.3e}, "
          f"saved arrays max |diff| {perr:.3e} (limits 1e-6) on {card}")
    if not (resumed and split["steps"] == 3 and lerr <= 1e-6
            and perr <= 1e-6):
        raise AssertionError("train(): the resumed run differs from the "
                             "uninterrupted one")


def lm_training(torch, dev, card: str, seed: int) -> float:
    """Phase 20: LM training, llama3.2-3b at full width (see the module
    docstring).  Returns the phase's seconds."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.dist.compress import compression_ratio
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adafactor, adamw

    start = time.perf_counter()
    cfg = configs.get(LM_ARCH)

    # 20.1: float32, batch 1: the backward against a central difference
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = Model(f32).init(torch.Generator(device=dev).manual_seed(seed),
                            dev)
    for seq in TRAIN_DD_SEQS:
        directional_check(torch, model, TokenPipeline(
            f32, 1, seq, seed, device=dev).batch_at(0), card)
    print(f"[train] float32 checks: peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
    del model
    torch.cuda.empty_cache()

    # 20.2: bfloat16 at train_4k's sequence length, AdamW
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                            dev)
    params = model.params()
    n = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n * tokens
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, device=dev)
    print(f"[train] {LM_ARCH} bfloat16: {n} parameters, {tokens} tokens a "
          f"step ({TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} micro-batches)"
          f", remat {cfg.remat_policy if cfg.remat else 'off'}; 6 N tokens = "
          f"{flops:.4e} FLOP a step on {card}")

    def run(opt, steps: int, first: int, what: str, **kw):
        state = opt.init(params)
        if kw.get("grad_compress"):
            from repro_torch.dist.compress import init_error_feedback
            state = dict(state, ef=init_error_feedback(params))
        step_fn = make_train_step(model, opt, micro_batches=TRAIN_MICRO,
                                  **kw)
        losses = []
        for i in range(first, first + steps):
            batch = pipe.batch_at(i)
            (state, met), sec = synced(torch, lambda: step_fn(state, batch,
                                                               i))
            losses.append(float(met["loss"]))
            print(f"[train] {what} step {i}: {sec:.4f} s, "
                  f"{tokens / sec:.1f} tokens/s, loss {losses[-1]:.6f}, "
                  f"6 N tokens at the bf16 dense peak "
                  f"{flops / BF16_FLOP_PER_S:.4f} s = "
                  f"{flops / BF16_FLOP_PER_S / sec:.4f} of the step on {card}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{what}: a loss is not finite: {losses}")
        return losses, state, step_fn

    # what the model learns: the first step's batch and one it never sees,
    # one sequence each, before and after the steps (each step's own loss
    # is on a new batch, and moves less than the batches differ)
    def held(index: int) -> float:
        with torch.no_grad():
            return model.loss({k: v[:1] for k, v in
                               pipe.batch_at(index).items()})[0].item()

    before = held(0), held(TRAIN_STEPS + 4)
    losses, state, step_fn = run(adamw(lr=3e-4), TRAIN_STEPS, 0, "AdamW")
    after = held(0), held(TRAIN_STEPS + 4)
    print(f"[train] AdamW {TRAIN_STEPS} steps: step loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; the first batch's first sequence "
          f"{before[0]:.6f} -> {after[0]:.6f}, an unseen batch's "
          f"{before[1]:.6f} -> {after[1]:.6f}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
    if not after[0] < before[0]:
        raise AssertionError(f"AdamW: the loss on the first batch did not "
                             f"fall: {before[0]} -> {after[0]}")

    # 20.3: where a step's time goes
    prof = profiled(torch, lambda i: step_fn(
        state, pipe.batch_at(TRAIN_STEPS + i), TRAIN_STEPS + i), 1,
        cpu=False)
    print(f"[train] one AdamW step under torch.profiler (the card's "
          f"activity alone): "
          f"{prof['kernels']:.0f} kernels, device {prof['device_ms']:.3f} ms "
          f"of {prof['wall_ms']:.3f} ms wall (busy share "
          f"{prof['device_ms'] / prof['wall_ms']:.3f}); the kernels with the "
          f"most device time: "
          + "; ".join(f"{name[:60]} x{n} {ms:.1f} ms"
                      for name, n, ms in prof["top"]) + f" on {card}")
    del step_fn
    split = _phase_split(torch, model, adamw(lr=3e-4), state,
                         pipe.batch_at(TRAIN_STEPS + 1), TRAIN_STEPS + 1)
    print("[train] the step's parts, CUDA-event ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" (sum {sum(split.values()):.3f}) on {card}")
    del state
    torch.cuda.empty_cache()

    # 20.4: Adafactor, then Adafactor with int8 gradient compression (the
    # AdamW moments, the residual and the accumulator together leave too
    # little of 80 GB for the activations)
    for what, kw in (("Adafactor", {}),
                     ("Adafactor + int8 compression",
                      {"grad_compress": True})):
        torch.cuda.reset_peak_memory_stats()
        first = TRAIN_STEPS + 2 + (2 if kw else 0)
        losses, state, step_fn = run(adafactor(), TRAIN_EXTRA_STEPS, first,
                                     what, **kw)
        ratio = ""
        if kw:
            acc = {k: torch.empty(p.shape, dtype=torch.float32,
                                  device="meta")
                   for k, p in model.named_parameters()}
            ratio = (f", compression ratio of the float32 gradient tree "
                     f"{compression_ratio(acc):.4f}")
        print(f"[train] {what}: peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB{ratio} on "
              f"{card}")
        del state, step_fn
        torch.cuda.empty_cache()
    del model, params
    torch.cuda.empty_cache()

    # 20.5: smoke width, card against CPU; 20.6: resume on the card
    _smoke_train_card_vs_cpu(torch, dev, card, seed)
    _resume_on_card(torch, dev, card, seed)
    return time.perf_counter() - start


def _whole(x):
    """A DTensor's whole value (a plain tensor as it is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _serve_timed(torch, model, batch: dict, card: str, what: str,
                profile: bool) -> dict:
    """``generate`` at MESH_GEN tokens on ``batch``, timed; with
    ``profile``, MESH_PROFILE_STEPS more decode steps under torch.profiler
    (kernels a step).  Returns the tokens, the logits (whole), the metrics
    and the numbers."""
    from repro_torch.launch.serve import generate

    torch.cuda.reset_peak_memory_stats()
    out, wall = synced(torch, lambda: generate(model, batch, gen=MESH_GEN))
    res = {"tokens": out["tokens"], "logits": _whole(out["logits"]),
           "metrics": {k: float(_whole(v)) for k, v in
                       out["metrics"].items()},
           "prefill_s": out["prefill_s"],
           "decode_ms": out["decode_s"] / (MESH_GEN - 1) * 1e3,
           "wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if profile:
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = model.init_cache(b, s + MESH_PROFILE_STEPS + 1)
        model.prefill({"tokens": tokens}, cache)
        model.decode_step(tokens[:, -1:], cache, s)
        prof = profiled(torch, lambda i: model.decode_step(
            tokens[:, -1:], cache, s + 1 + i), MESH_PROFILE_STEPS)
        res["kernels"] = prof["kernels"]
        res["busy"] = prof["device_ms"] / prof["wall_ms"]
        del cache
    print(f"[mesh] {what}: prefill_s={res['prefill_s']:.4f} decode "
          f"{res['decode_ms']:.3f} ms a step"
          + (f", {res['kernels']:.0f} kernels a step (busy share "
             f"{res['busy']:.3f})" if profile else "")
          + f", peak {res['peak_gb']:.2f} GB"
          + (f", moe_drop_frac {res['metrics']['moe_drop_frac']:.4f}"
             if "moe_drop_frac" in res["metrics"] else "")
          + f" on {card}")
    if not bool(torch.isfinite(res["logits"]).all()):
        raise AssertionError(f"{what}: non-finite logits")
    return res


def _same_serving(torch, plain: dict, meshed: dict, what: str) -> float:
    """The mesh path against the plain one: the same greedy tokens and
    logits within phase 18's bfloat16 limits (rtol 1e-2, atol 2e-2)."""
    if not (plain["tokens"] == meshed["tokens"]).all():
        raise AssertionError(f"{what}: greedy tokens differ with the mesh")
    return max_err(torch, meshed["logits"].float(), plain["logits"].float(),
                   rtol=1e-2, atol=2e-2, what=f"{what} logits, mesh vs plain")


def _forced_logits(torch, model, batch: dict, tokens) -> object:
    """Prefill ``batch``, then decode ``tokens`` (B, n) (numpy: another
    path's greedy tokens), each step's last-position logits whole (B, n,
    V): two paths compared on the same inputs at every step."""
    t = batch["tokens"]
    b, s = t.shape
    n = tokens.shape[1]
    ids = torch.as_tensor(tokens, device=t.device)
    cache = model.init_cache(b, s + n)
    logits, _ = model.prefill(batch, cache)
    steps = [_whole(logits)[:, -1]]
    for i in range(n - 1):
        logits, _ = model.decode_step(ids[:, i:i + 1], cache, s + i)
        steps.append(_whole(logits)[:, -1])
    return torch.stack(steps, dim=1)


def lm_mesh(torch, dev, card: str, seed: int) -> tuple[float, float]:
    """Phase 21: the production mesh's path on one card (see the module
    docstring).  Returns the phase's seconds and those of the AdamW step
    without the hook."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.dist.collectives import init_process_group_for, make_mesh
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import axes_tree
    from repro_torch.optim import adamw

    start = time.perf_counter()
    own = init_process_group_for(dev)
    try:
        grid = make_mesh((1, 1), ("data", "model"))
        cfg = configs.get(LM_ARCH)
        rules = M.rules_for(cfg)
        sfn = M.sharding_fn(grid, rules)
        model = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                                dev)
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, cfg.vocab, (MESH_BATCH, MESH_PROMPT),
                           dtype=np.int32)
        batch = serve_batch(model, ids, rng)
        tb = TokenPipeline(cfg, 1, MESH_TRAIN_SEQ, seed, device=dev
                           ).batch_at(0)
        w0 = {k: v.detach().to("cpu", copy=True)
              for k, v in model.state_dict().items()}

        # 21.1: llama3.2-3b without the hook: serve, then one AdamW step
        plain = _serve_timed(torch, model, batch, card,
                            f"{LM_ARCH} bfloat16 batch {MESH_BATCH} prompt "
                            f"{MESH_PROMPT} gen {MESH_GEN}, no hook", True)
        opt = adamw()
        state = opt.init(model.params())
        torch.cuda.reset_peak_memory_stats()
        (state, met), p_step_s = synced(torch, lambda: make_train_step(
            model, opt)(state, tb, 0))
        p_loss, p_peak = float(met["loss"]), \
            torch.cuda.max_memory_allocated() / 1e9
        w1 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del state, met
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(w0[k])
        del w0
        torch.cuda.empty_cache()
        print(f"[mesh] {LM_ARCH} one AdamW step at 1 x {MESH_TRAIN_SEQ} "
              f"tokens, no hook: {p_step_s:.4f} s, loss {p_loss:.6f}, peak "
              f"{p_peak:.2f} GB on {card}")

        # 21.2: the same weights placed on the grid, the hook installed
        place_s = synced(torch, lambda: M.place_model(model, sfn))[1]
        M.install(grid, rules)
        meshed = _serve_timed(torch, model, batch, card,
                             f"{LM_ARCH} the same, through the mesh", True)
        err = _same_serving(torch, plain, meshed, LM_ARCH)
        opt = adamw()
        state = M.place(opt.init(model.params()),
                        opt.state_axes(axes_tree(model.param_specs())), sfn)
        torch.cuda.reset_peak_memory_stats()
        (state, met), m_step_s = synced(torch, lambda: make_train_step(
            model, opt)(state, tb, 0))
        m_loss = float(_whole(met["loss"]))
        m_peak = torch.cuda.max_memory_allocated() / 1e9
        rel = abs(m_loss - p_loss) / abs(p_loss)
        if not rel <= 1e-2:
            raise AssertionError(f"{LM_ARCH} mesh step loss {m_loss} vs "
                                 f"{p_loss}: relative {rel:.3e} > 1e-2")
        perr = max(max_err(torch, _whole(v).float(), w1[k].float(),
                           rtol=0.0, atol=2e-2,
                           what=f"{LM_ARCH} {k} after the step, mesh vs "
                           f"plain")
                   for k, v in model.state_dict().items())
        print(f"[mesh] {LM_ARCH} through a (data=1, model=1) grid on one "
              f"NCCL rank, parameters placed in {place_s:.4f} s: greedy "
              f"tokens equal, logits max |diff| {err:.3e} (limits rtol "
              f"1e-2, atol 2e-2); AdamW step {m_step_s:.4f} s (no hook "
              f"{p_step_s:.4f} s), loss {m_loss:.6f} (relative diff "
              f"{rel:.3e}, limit 1e-2), parameters after it within "
              f"{perr:.3e} (limit 2e-2), peak {m_peak:.2f} GB (no hook "
              f"{p_peak:.2f} GB); host cost of the mesh: prefill "
              f"{meshed['prefill_s'] - plain['prefill_s']:+.4f} s, decode "
              f"{meshed['decode_ms'] - plain['decode_ms']:+.3f} ms a step, "
              f"step {m_step_s - p_step_s:+.4f} s on {card}")
        M.uninstall()
        del model, state, met, w1
        torch.cuda.empty_cache()

        # 21.3: dbrx-132b at phase 19's cut, through moe_ffn_ep on the grid
        # against the dense dispatch: at a capacity factor where nothing
        # drops, then at the preset's own
        base = dataclasses.replace(configs.get(MESH_MOE_ARCH),
                                   num_layers=FAMILY_LAYERS[MESH_MOE_ARCH])
        no_drop = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=MESH_NO_DROP_CF))
        rules = M.rules_for(base)
        sfn = M.sharding_fn(grid, rules)
        model = Model(no_drop).init(
            torch.Generator(device=dev).manual_seed(seed), dev)
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, base.vocab, (MESH_BATCH, MESH_PROMPT),
                           dtype=np.int32)
        batch = serve_batch(model, ids, rng)
        tag = (f"{MESH_MOE_ARCH} ({base.num_layers} of "
               f"{configs.get(MESH_MOE_ARCH).num_layers} layers) bfloat16 "
               f"batch {MESH_BATCH} prompt {MESH_PROMPT} gen {MESH_GEN}")

        def runs(m, cfg2, what):
            if cfg2 is not None:  # the same tensors under another config
                m2 = Model(cfg2)
                m2.load_state_dict(m.state_dict(), assign=True)
                m = m2
            return _serve_timed(torch, m, batch, card, what, False)

        d_plain = runs(model, None, f"{tag}, capacity factor "
                       f"{MESH_NO_DROP_CF}, dense dispatch")
        want = _forced_logits(torch, model, batch, d_plain["tokens"])
        noise = float((_forced_logits(torch, model, batch, d_plain["tokens"])
                       .float() - want.float()).abs().max())
        d_pre = runs(model, base, f"{tag}, capacity factor "
                     f"{base.moe.capacity_factor}, dense dispatch")
        # layer by layer: layer 0's MoE FFN on the same input at the
        # prefill's and a decode step's shape, the dense dispatch here and
        # the expert-parallel one under the grid below: the same routes.
        # In float32 the two must agree; in bfloat16 their difference is
        # set beside the dense dispatch's own from run to run
        layer = []
        for s in (MESH_PROMPT, 1):
            g = torch.Generator(device=dev).manual_seed(seed + s)
            x = torch.randn((MESH_BATCH, s, base.d_model), generator=g,
                            device=dev)
            p16 = {k: v[0] for k, v in
                   model.params()["stack"]["b0"]["moe"].items()}
            with torch.no_grad():
                d32 = MOE._moe_ffn_dense_dispatch(
                    {k: v.float() for k, v in p16.items()}, no_drop, x)[0]
                d16 = [MOE._moe_ffn_dense_dispatch(
                    p16, no_drop, x.to(base.cdtype))[0] for _ in range(2)]
            layer.append({"x": x, "d32": d32, "d16": d16})
        del p16
        M.place_model(model, sfn)
        M.install(grid, rules)
        p16 = {k: v[0] for k, v in model.params()["stack"]["b0"]["moe"].items()}
        p32 = M.place({k: _whole(v).float() for k, v in p16.items()},
                      axes_tree(MOE.moe_specs(no_drop)), sfn)
        for lay in layer:
            x, s = lay["x"], lay["x"].shape[1]
            with torch.no_grad():
                (e32, m32), n32 = _count_ep(torch, lambda: MOE.moe_ffn(
                    p32, no_drop, x))
                (e16, m16), n16 = _count_ep(torch, lambda: MOE.moe_ffn(
                    p16, no_drop, x.to(base.cdtype)))
            if (n32, n16) != (1, 1) or float(_whole(m32["moe_drop_frac"])) \
                    or float(_whole(m16["moe_drop_frac"])):
                raise AssertionError(f"{MESH_MOE_ARCH} layer 0 at {s} "
                                     f"positions: moe_ffn_ep not taken, or "
                                     f"tokens dropped")
            lay["err32"] = max_err(
                torch, _whole(e32), lay["d32"], rtol=1e-4, atol=1e-4,
                what=f"{MESH_MOE_ARCH} layer 0's MoE FFN at {s} positions "
                f"in float32, moe_ffn_ep vs the dense dispatch")
            d16a, d16b = (d.float() for d in lay["d16"])
            diff = (_whole(e16).float() - d16a).abs()
            lay["err16"] = float(diff.max())
            lay["over16"] = float((diff > 2e-2 + 1e-2 * d16a.abs()).float()
                                  .mean())
            lay["spread16"] = float((d16b - d16a).abs().max())
            lay["max16"] = float(d16a.abs().max())
            print(f"[mesh] {MESH_MOE_ARCH} layer 0's MoE FFN at {s} "
                  f"positions (batch {MESH_BATCH}, capacity factor "
                  f"{MESH_NO_DROP_CF}): moe_ffn_ep vs the dense dispatch in "
                  f"float32 max |diff| {lay['err32']:.3e} (limits rtol "
                  f"1e-4, atol 1e-4); in bfloat16 max |diff| "
                  f"{lay['err16']:.4e}, share over rtol 1e-2 / atol 2e-2 "
                  f"{lay['over16']:.3e}, against the dense dispatch's own "
                  f"spread from run to run {lay['spread16']:.4e} (max "
                  f"|out| {lay['max16']:.3f}) on {card}")
        del p16, p32, layer, e32, e16
        torch.cuda.empty_cache()

        e_mesh, n_ep = _count_ep(torch, lambda: runs(
            model, None, f"{tag}, capacity factor {MESH_NO_DROP_CF}, "
            f"moe_ffn_ep"))
        got = _forced_logits(torch, model, batch, d_plain["tokens"])
        e_pre, _ = _count_ep(torch, lambda: runs(
            model, base, f"{tag}, capacity factor "
            f"{base.moe.capacity_factor}, moe_ffn_ep"))
        # the whole model: a router's near-tie flips an assignment when a
        # bfloat16 sum is taken in another order, and the flip carries to
        # the next layers, so the dense dispatch does not reproduce itself
        # from run to run (its index_add_); the expert-parallel run is set
        # beside that spread on the same tokens
        diff = (got.float() - want.float()).abs()
        over = float((diff > 2e-2 + 1e-2 * want.float().abs()).float().mean())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        same = float((e_mesh["tokens"] == d_plain["tokens"]).mean())
        if d_plain["metrics"]["moe_drop_frac"] or \
                e_mesh["metrics"]["moe_drop_frac"]:
            raise AssertionError(f"{MESH_MOE_ARCH}: tokens dropped at "
                                 f"capacity factor {MESH_NO_DROP_CF}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{MESH_MOE_ARCH}: non-finite logits")
        expect = base.num_layers * MESH_GEN
        if n_ep != expect:
            raise AssertionError(f"{MESH_MOE_ARCH}: moe_ffn_ep ran {n_ep} "
                                 f"times, not {expect} (every MoE layer a "
                                 f"step)")
        print(f"[mesh] {tag}, capacity factor {MESH_NO_DROP_CF} (nothing "
              f"dropped): generate through moe_ffn_ep ({n_ep} calls, each "
              f"with two one-rank all_to_alls on NCCL); the whole model on "
              f"the dense dispatch's tokens: logits max |diff| "
              f"{float(diff.max()):.4e} (share over the limits {over:.3e}, "
              f"argmax agreeing at {agree:.4f}, max |logit| "
              f"{float(want.float().abs().max()):.3f}) against the dense "
              f"dispatch's own spread from run to run, max |diff| "
              f"{noise:.4e}; greedy tokens of the two generate runs "
              f"agreeing at {same:.4f}; at the preset's "
              f"{base.moe.capacity_factor}: prefill moe_drop_frac dense "
              f"{d_pre['metrics']['moe_drop_frac']:.4f}, expert-parallel "
              f"{e_pre['metrics']['moe_drop_frac']:.4f} on {card}")
        M.uninstall()
        del model, batch
        torch.cuda.empty_cache()
    finally:
        M.uninstall()
        if own:
            dist.destroy_process_group()
    return time.perf_counter() - start, p_step_s


def _cell_line(art: dict) -> str:
    r, m = art["roofline"], art["memory"]
    mix = ", ".join(f"{k} {int(v['count'])} x ({v['bytes']:.4g} B, wire "
                    f"{v['wire']:.4g} B)"
                    for k, v in sorted(r["collectives"].items()))
    return (f"{art['cell']} on {art['mesh']}: dominant {r['dominant']}, "
            f"bound {r['bound_s'] * 1e3:.4f} ms (compute "
            f"{r['compute_s'] * 1e3:.4f}, memory {r['memory_s'] * 1e3:.4f}, "
            f"collective {r['collective_s'] * 1e3:.4f} ms), useful ratio "
            f"{r['useful_ratio']:.4f}, peak_estimate_gib "
            f"{m['peak_estimate_gib']}; collectives: {mix or 'none'}; traced "
            f"in {art['compile_s']:.2f} s")


def dry_run(card: str, step_s: float, iteration: dict) -> float:
    """Phase 22: the dry-run (see the module docstring): each of
    ``DRYRUN_CELLS`` in a subprocess of its own (its fake group), and the
    one-rank grids, all at once; every count is traced on ``meta`` and
    turned into time by the H100's constants (``utils/roofline.py``).
    Fails when a process fails or outlasts ``DRYRUN_BUDGET_S``, or when a
    one-rank bound is not below the card's time.  Returns the phase's
    seconds."""
    start = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    with tempfile.TemporaryDirectory(prefix="dryrun-") as out:
        procs = {}
        for arch, shape, mesh in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--mesh", mesh, "--out", out]
            if shape:
                cmd += ["--shape", shape]
            procs[f"{arch} {shape or 'iteration'} {mesh}"] = cmd
        procs["one-rank grids"] = [
            sys.executable, "-c", DRYRUN_ONE_RANK, out, LM_ARCH,
            str(MESH_TRAIN_SEQ), ",".join(iteration["impls"])]
        running = {name: subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for name, cmd in procs.items()}
        outs, failed = {}, []
        try:
            for name, p in running.items():
                left = DRYRUN_BUDGET_S - (time.perf_counter() - start)
                try:
                    outs[name] = p.communicate(timeout=max(left, 1.0))[0]
                except subprocess.TimeoutExpired:
                    failed.append(f"{name}: past the {DRYRUN_BUDGET_S} s "
                                  "budget")
                    continue
                if p.returncode:
                    failed.append(f"{name}: exit {p.returncode}\n"
                                  f"{outs[name][-3000:]}")
        finally:
            for p in running.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if failed:
            raise AssertionError("the dry-run: " + "\n".join(failed))
        arts = {p.stem: json.loads(p.read_text())
                for p in sorted(Path(out).glob("*.json"))}
    for name, art in arts.items():
        if not name.endswith("one_rank"):
            print(f"[dryrun] {_cell_line(art)} (traced counts over the H100 "
                  f"constants, 989.4 / 66.9 TFLOP/s, 3.35 TB/s, links 450 / "
                  f"50 GB/s; nothing measured on {card})")
    if len(arts) != len(DRYRUN_CELLS) + 1:
        raise AssertionError(f"the dry-run wrote {sorted(arts)}")

    lm = arts[f"{LM_ARCH}__train_1x{MESH_TRAIN_SEQ}__single__one_rank"]
    cp = json.loads(re.search(r"^CPALS (.*)$", outs["one-rank grids"],
                              re.M).group(1))
    checks = ((f"{LM_ARCH} one AdamW step at 1 x {MESH_TRAIN_SEQ} tokens",
               lm["roofline"], step_s, "phase 21's step without the hook"),
              ("cpals-yelp's dist iteration, local impls "
               f"{','.join(iteration['impls'])}, cap "
               f"{cp['info']['local_cap']} entries", cp["roofline"],
               iteration["s"], "phase 16's shard_c=False iteration, "
               f"(fit - partition) / {NITERS}"))
    bad = []
    for what, r, measured, source in checks:
        ratio = r["bound_s"] / measured
        print(f"[dryrun] one-rank grid, {what}: traced bound "
              f"{r['bound_s']:.6f} s ({r['dominant']}; compute "
              f"{r['compute_s']:.6f}, memory {r['memory_s']:.6f} s; "
              f"{r['flops']:.4e} flops, {r['bytes_accessed']:.4e} bytes) "
              f"against {measured:.6f} s measured ({source}) on {card}: "
              f"bound / measured {ratio:.4f}")
        if not ratio < 1.0:
            bad.append(what)
    if bad:
        raise AssertionError(f"the dry-run's bound is above the card's "
                             f"time for {bad}: the count is wrong")
    seconds = time.perf_counter() - start
    if seconds > DRYRUN_BUDGET_S:
        raise AssertionError(f"the dry-run phase took {seconds:.1f} s, over "
                             f"its {DRYRUN_BUDGET_S} s budget")
    return seconds


def _count_ep(torch, fn):
    """``fn()`` with the calls of ``moe_ffn_ep`` counted: (result,
    calls)."""
    from repro_torch.models import moe as MOE

    calls = [0]
    real = MOE.moe_ffn_ep

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    MOE.moe_ffn_ep = counted
    try:
        return fn(), calls[0]
    finally:
        MOE.moe_ffn_ep = real


def _leaves(tree: dict):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _profile_family(torch, model, batch: dict, card: str, arch: str,
                    prompt: int) -> None:
    """Where a served family's time goes, under torch.profiler: a few
    decode steps at position ``prompt`` of a zeroed cache (a step's work
    does not depend on the cache's values) and, for an MoE model, one
    prefill of ``batch``: kernels a call, the busy share, and the MoE
    dispatch's kernels and device time."""
    cfg = model.cfg
    dev = model.device
    src = batch["src_embeds"].shape[1] if cfg.encdec else 0
    cache = model.init_cache(FAMILY_BATCH, prompt + LM_PROFILE_STEPS + 1,
                             src_len=src)
    tok = torch.zeros((FAMILY_BATCH, 1), dtype=torch.int32, device=dev)

    def step(i):
        pos = prompt + i
        positions = None
        if cfg.rope == "mrope":
            positions = torch.full((3, FAMILY_BATCH, 1), pos,
                                   dtype=torch.int32, device=dev)
        model.decode_step(tok, cache, pos, positions=positions)

    step(0)  # warm-up
    calls = [("decode step", profiled(
        torch, lambda i: step(1 + i), LM_PROFILE_STEPS), LM_PROFILE_STEPS)]
    if cfg.moe:
        calls.append(("prefill", profiled(
            torch, lambda i: model.prefill(batch, cache), 1), 1))
    for what, prof, n in calls:
        line = (f"[families] {arch} {what} under torch.profiler ({n} "
                f"call{'s' if n > 1 else ''}, batch {FAMILY_BATCH}, "
                f"prompt {prompt}): {prof['kernels']:.0f} kernels a call, "
                f"device {prof['device_ms']:.3f} ms of {prof['wall_ms']:.3f} "
                f"ms wall (busy share "
                f"{prof['device_ms'] / prof['wall_ms']:.3f})")
        if cfg.moe:
            line += (f"; MoE dispatch (sort, search, index, gather and "
                     f"scatter kernels): {prof['dispatch']:.0f} kernels, "
                     f"{prof['dispatch_ms']:.3f} ms device")
        print(f"{line} on {card}")


def main() -> int:
    start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import (build_all_modes, build_linearized,
                                  init_factors, paper_dataset)
    from repro_torch.core.cpals import (ROUTINES_FUSED, CPALSState,
                                        _mode_epilogue)
    from repro_torch.core.gram import gram, kruskal_norm_sq
    from repro_torch.kernels import (_build, linearized_cuda, mttkrp_cuda, ops,
                                     ref, syrk_cuda)
    from repro_torch.methods import fit, make_state
    from repro_torch.methods.tucker_hooi import _init_orthonormal
    from repro_torch.core.csf import DEFAULT_BLOCK, DEFAULT_ROW_TILE
    from repro_torch.ingest import content_key
    from repro_torch.plan import AutotuneStore, plan_decomposition, tensor_stats

    counters = {"mttkrp": mttkrp_cuda.mttkrp, "syrk": syrk_cuda.syrk,
                "mttkrp_lin": linearized_cuda.mttkrp,
                "mttkrp_off_sort": linearized_cuda.mttkrp_off_sort,
                "ttmc": mttkrp_cuda.ttmc, "ttmc_lin": linearized_cuda.ttmc,
                "ttmc_off_sort": linearized_cuda.ttmc_off_sort}
    none = dict.fromkeys(counters, 0)

    def zero_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict[str, int]:
        return {name: fn.launches for name, fn in counters.items()}

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] kernels built in {build_s:.3f} s")
    rows = [(lib, *row) for lib, log in _build.BUILD_LOG.items()
            for row in build_lines(log)]
    spilled = []
    for (lib, _, regs, stack, spill), kernel in zip(
            rows, demangle([row[1] for row in rows])):
        print(f"[build] {lib}: {regs} registers, {stack} B stack, "
              f"{spill} B spill: {kernel}")
        if spill:
            spilled.append(kernel)
    if _build.BUILD_LOG:
        print(f"[build] kernels that spill: {spilled if spilled else 'none'}")
    else:
        print("[build] every library was built before this run: no ptxas "
              "report")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # --- 2. K1: MTTKRP on full-size yelp ------------------------------------
    t0 = time.perf_counter()
    t = paper_dataset("yelp", args.seed, scale=1.0, device=dev)
    csfs = build_all_modes(t)
    torch.cuda.synchronize()
    print(f"[data] yelp dims={t.dims} nnz={t.nnz} built+sorted in "
          f"{time.perf_counter() - t0:.3f} s; (rows, padded nnz, blocks) "
          f"per mode: "
          + ", ".join(f"({c.num_rows}, {c.padded_nnz}, {c.num_blocks})"
                      for c in csfs))
    factors = init_factors(t.dims, RANK, args.seed + 1, device=dev)
    k1 = totals()
    for csf in csfs:
        got = ops.mttkrp(csf, factors)
        want = ref.mttkrp_ref(csf, factors)
        err = max_err(torch, got, want, rtol=1e-4, atol=1e-4,
                      what=f"K1 mode {csf.mode} float32")
        fb = tuple(a.bfloat16() for a in factors)
        err_bf16 = max_err(torch, ops.mttkrp(csf, fb),
                           ref.mttkrp_ref(csf, fb).bfloat16(), rtol=5e-2,
                           atol=5e-2, what=f"K1 mode {csf.mode} bfloat16")
        ms = time_ms(torch, lambda: ops.mttkrp(csf, factors))
        plain_ms = time_ms(torch, lambda: ref.mttkrp_ref(csf, factors))
        n_other = csf.order - 1
        nbytes = (csf.padded_nnz * (4 + 4 * n_other + 4)
                  + sum(csf.dims[m] * RANK * 4 for m in csf.other_modes)
                  + csf.num_rows * RANK * 4)
        ops_count = csf.padded_nnz * RANK * (n_other + 1)
        b_ms, b_by = bound(nbytes, ops_count)
        gathered = gathered_bytes(csf.other_ids.unbind(1),
                                  [RANK * 4] * n_other)
        print(f"[K1] mode {csf.mode} err f32={err:.3e} bf16={err_bf16:.3e}"
              f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}, {nbytes / 1e6:.1f} MB); L2 gathers "
              f"{gathered / 1e9:.3f} GB at {gathered / ms / 1e6:.1f} GB/s; "
              f"{mttkrp_cuda.mttkrp_geometry(csf.padded_nnz, RANK)}")
        add_times(k1, ms, plain_ms, nbytes, ops_count)
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
    del got, want

    # --- 3. K2: SYRK at the factor shapes ----------------------------------
    k2 = dict(totals(), library_ms=0.0)
    for m, a in enumerate(factors):
        err = max_err(torch, ops.syrk(a), ref.syrk_ref(a), rtol=1e-4,
                      atol=1e-3, what=f"K2 factor {m}")
        ms = time_ms(torch, lambda: ops.syrk(a))
        plain_ms = time_ms(torch, lambda: ref.syrk_ref(a))
        library_ms = time_ms(torch, lambda: torch.matmul(a.T, a))
        run_ms = time_per_launch_ms(torch, lambda: ops.syrk(a))
        run_library_ms = time_per_launch_ms(torch,
                                            lambda: torch.matmul(a.T, a))
        dev_us, dev_library_us = (
            device_us(torch, f) for f in (lambda: ops.syrk(a),
                                          lambda: torch.matmul(a.T, a)))
        rows = a.shape[0]
        nbytes = rows * RANK * 4 + RANK * RANK * 4
        ops_count = 2 * rows * RANK * RANK
        b_ms, b_by = bound(nbytes, ops_count)
        print(f"[K2] {rows}x{RANK} err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}); per launch of 100 "
              f"back-to-back: ms={run_ms:.4f} library_ms="
              f"{run_library_ms:.4f}; device us a call (torch.profiler): "
              f"{dev_us if dev_us else 'not measured'} library "
              f"{dev_library_us if dev_library_us else 'not measured'}")
        add_times(k2, ms, plain_ms, nbytes, ops_count)
        k2["library_ms"] += library_ms
        k2["max_abs_err"] = max(k2["max_abs_err"], err)

    # the steady-state epilogue per mode update, apart from the one-off
    # library set-up that the fit's first iteration pays
    grams = tuple(gram(a) for a in factors)
    norm_x_sq = torch.sum(t.vals.float() ** 2)
    epilogue_ms = []
    for csf in csfs:
        m_mat = ops.mttkrp(csf, factors)
        epilogue_ms.append(time_ms(torch, lambda: _mode_epilogue(
            m_mat, factors, grams, norm_x_sq, mode=csf.mode, norm_kind="2",
            with_fit=csf.mode == t.order - 1)))
    print("[epilogue] ms per mode: "
          + " ".join(f"{ms:.4f}" for ms in epilogue_ms))

    # --- 4. K3: MTTKRP on the linearized workspace ------------------------
    def lin_mttkrp_bound(lin, mode: int):
        """Bytes, operations and bound of one linearized MTTKRP call on
        ``mode``: 12 B a stored entry, the other factors, the output."""
        nbytes = (lin.padded_nnz * 12
                  + sum(t.dims[m] * RANK * 4 for m in range(t.order)
                        if m != mode)
                  + t.dims[mode] * RANK * 4)
        ops_count = lin.padded_nnz * RANK * t.order
        return nbytes, ops_count, *bound(nbytes, ops_count)

    def lin_gathers(lin, mode: int, ranks) -> int:
        """L2 sector bytes of the factor rows a linearized call on ``mode``
        gathers, the factors of ``ranks`` in float32."""
        others = [m for m in range(t.order) if m != mode]
        return gathered_bytes([lin.decode(m) for m in others],
                              [ranks[m] * 4 for m in others])

    k3, k3off = totals(), totals()
    lins = {}  # kept for the TTMc phase
    for sm in (0, 1):
        t0 = time.perf_counter()
        lin = build_linearized(t, sort_mode=sm)
        torch.cuda.synchronize()
        lin_s = time.perf_counter() - t0
        print(f"[K3] sort mode {sm}: widths={lin.widths} "
              f"offsets={lin.offsets} padded nnz={lin.padded_nnz} "
              f"blocks={lin.num_blocks} host build {lin_s:.3f} s")
        got = ops.mttkrp_lin(lin, factors, sm)
        err = max_err(torch, got, ref.mttkrp_lin_ref(lin, factors, sm),
                      rtol=1e-4, atol=1e-4, what=f"K3 sort mode {sm} float32")
        err_k1 = max_err(torch, got, ops.mttkrp(csfs[sm], factors),
                         rtol=1e-4, atol=1e-4, what=f"K3 vs K1 mode {sm}")
        fb = tuple(a.bfloat16() for a in factors)
        err_bf16 = max_err(torch, ops.mttkrp_lin(lin, fb, sm),
                           ref.mttkrp_lin_ref(lin, fb, sm).bfloat16(),
                           rtol=5e-2, atol=5e-2,
                           what=f"K3 sort mode {sm} bfloat16")
        ms = time_ms(torch, lambda: ops.mttkrp_lin(lin, factors, sm))
        plain_ms = time_ms(torch,
                           lambda: ref.mttkrp_lin_ref(lin, factors, sm))
        nbytes, ops_count, b_ms, b_by = lin_mttkrp_bound(lin, sm)
        gathered = lin_gathers(lin, sm, [RANK] * t.order)
        print(f"[K3] sort mode {sm} err f32={err:.3e} vs K1={err_k1:.3e} "
              f"bf16={err_bf16:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB); L2 "
              f"gathers {gathered / 1e9:.3f} GB at "
              f"{gathered / ms / 1e6:.1f} GB/s")
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        if sm == 0:  # the sort mode the linearized fit runs
            add_times(k3, ms, plain_ms, nbytes, ops_count)
        for tm in (m for m in range(t.order) if m != sm):
            got = ops.mttkrp_lin(lin, factors, tm)
            what = f"off-sort MTTKRP sort mode {sm} mode {tm}"
            err = max_err(torch, got, ref.mttkrp_lin_ref(lin, factors, tm),
                          rtol=1e-4, atol=1e-4, what=f"{what} float32")
            err_k1 = max_err(torch, got, ops.mttkrp(csfs[tm], factors),
                             rtol=1e-4, atol=1e-4, what=f"{what} vs K1")
            err_bf16 = max_err(torch, ops.mttkrp_lin(lin, fb, tm),
                               ref.mttkrp_lin_ref(lin, fb, tm).bfloat16(),
                               rtol=5e-2, atol=5e-2, what=f"{what} bfloat16")
            ms = time_ms(torch, lambda: ops.mttkrp_lin(lin, factors, tm))
            plain_ms = time_ms(torch,
                               lambda: ref.mttkrp_lin_ref(lin, factors, tm))
            nbytes, ops_count, b_ms, b_by = lin_mttkrp_bound(lin, tm)
            gathered = lin_gathers(lin, tm, [RANK] * t.order)
            red = atomic_runs(torch, lin.decode(tm), mttkrp_cuda.SEGMENT)
            print(f"[K3-off] sort mode {sm} mode {tm} err f32={err:.3e} vs "
                  f"K1={err_k1:.3e} bf16={err_bf16:.3e} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
                  f"{nbytes / 1e6:.1f} MB); L2 gathers {gathered / 1e9:.3f} "
                  f"GB at {gathered / ms / 1e6:.1f} GB/s; atomics {red} runs"
                  f" x {RANK} x 4 B = {red * RANK * 4 / 1e9:.3f} GB at "
                  f"{red * RANK * 4 / ms / 1e6:.1f} GB/s")
            k3off["max_abs_err"] = max(k3off["max_abs_err"], err)
            if sm == 0:  # the modes the linearized fit runs off the sort
                add_times(k3off, ms, plain_ms, nbytes, ops_count)
        lins[sm] = lin
        del lin, got

    # --- 5. the main path ---------------------------------------------------
    init = init_factors(t.dims, RANK, args.seed + 2, device=dev)
    zero = torch.tensor(0.0, device=dev)
    state = CPALSState(init, torch.ones(RANK, device=dev), zero, zero,
                       torch.tensor(0, dtype=torch.int32))
    def timed_fit(impl: str, want_launches: dict[str, int]):
        """One 20-iteration timed fit from ``state``, launch counts set to
        0 just before and checked just after."""
        timers: dict[str, float] = {}
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = fit(t, RANK, method="cp_als", impl=impl, niters=NITERS,
                  timers=timers, fused_epilogue=True, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(f"[fit] impl={impl} fit={float(dec.fit):.7f} wall_s={wall:.4f}"
              f" launches={counts} "
              + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                         for k in ROUTINES_FUSED))
        if counts != want_launches:
            raise AssertionError(f"impl={impl} launches {counts}, expected "
                                 f"{want_launches}")
        for m, a in enumerate(dec.factors):
            if (tuple(a.shape) != (t.dims[m], RANK)
                    or not torch.isfinite(a).all()):
                raise AssertionError(f"impl={impl} factor {m}: shape "
                                     f"{tuple(a.shape)} or non-finite values")
        return dec, dict(timers, wall=wall), counts

    def check_against_segment(dec, what: str, factors_too: bool = True,
                              want=None, tag: str = "fit",
                              against: str = "segment"):
        """Hold ``dec`` to a plain ``segment`` fit (phase 5's unless
        ``want`` is given; ``against`` names it) at the CP limits."""
        want = dec_seg if want is None else want
        fit_got, fit_seg = float(dec.fit), float(want.fit)
        fit_diff = abs(fit_got - fit_seg)
        lmbda_rel, factor_rel = rel_diffs(torch, dec, want)
        print(f"[{tag}] {what} vs {against} fit={fit_seg:.7f} "
              f"|diff|={fit_diff:.3e} lambda rel={lmbda_rel:.3e} factor rel="
              + " ".join(f"{r:.3e}" for r in factor_rel))
        if not math.isfinite(fit_got) or fit_diff > 1e-5:
            raise AssertionError(f"{what}: fit {fit_got} vs {against} "
                                 f"{fit_seg}")
        if factors_too and (lmbda_rel > 3e-2 or max(factor_rel) > 3e-2):
            raise AssertionError(f"{what}: lambda or a factor differs from "
                                 f"{against}'s by more than a relative 3e-2")

    dec, csf_times, launches = timed_fit(
        "cuda", dict(none, mttkrp=t.order * NITERS))
    dec_seg = fit(t, RANK, method="cp_als", impl="segment", niters=NITERS,
                  state=state)
    check_against_segment(dec, "impl=cuda")

    # --- 6. the linearized path ---------------------------------------------
    dec_lin, lin_times, lin_launches = timed_fit(
        "linearized_cuda", dict(none, mttkrp_lin=NITERS,
                                mttkrp_off_sort=(t.order - 1) * NITERS))
    check_against_segment(dec_lin, "impl=linearized_cuda")
    for name in ("mttkrp_lin", "mttkrp_off_sort"):
        launches[name] = lin_launches[name]
    print("[fit] routine s (csf cuda | linearized_cuda): "
          + " ".join(f"{k}={csf_times[k]:.4f}|{lin_times[k]:.4f}"
                     for k in ("sort", "mttkrp", "epilogue", "wall")))

    # --- 7. the measured planner ------------------------------------------
    # a store hit returns the stored table without timing anything, so 3
    # hits and no new miss on the second plan mean no timing run
    with tempfile.TemporaryDirectory(prefix="autotune-") as root:
        store = AutotuneStore(root)
        t0 = time.perf_counter()
        plan = plan_decomposition(t, "auto", rank=RANK, calibrate=True,
                                  autotune=store)
        print(f"[plan] calibrated in {time.perf_counter() - t0:.3f} s")
        for p in plan.modes:
            print(f"[plan] mode {p.mode} {p.source} winner={p.impl} ms: "
                  + " ".join(f"{k}={v:.4f}" for k, v in p.costs.items()))
        # the second plan's host work, split: the tensor's content key,
        # the per-mode stats pass, then the plan from the store
        t0 = time.perf_counter()
        key = content_key(t, block=DEFAULT_BLOCK, row_tile=DEFAULT_ROW_TILE)
        key_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = tensor_stats(t, block=DEFAULT_BLOCK,
                             row_tile=DEFAULT_ROW_TILE)
        stats_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = plan_decomposition(t, "auto", rank=RANK, calibrate=True,
                                   autotune=store, tensor_key=key,
                                   stats=stats)
        print(f"[plan] second plan: content key {key_s:.3f} s, stats "
              f"{stats_s:.3f} s, plan {time.perf_counter() - t0:.3f} s: "
              f"sources={[p.source for p in again.modes]} "
              f"impls={again.impls} hits={store.hits} misses={store.misses}")
    if (any(p.source != "measured-fresh" for p in plan.modes)
            or set(plan.modes[0].costs) != {
                "cuda", "gather_scatter", "linearized", "linearized_cuda",
                "segment"}):
        raise AssertionError("the first calibrated plan was not measured "
                             "over every candidate")
    if (any(p.source != "measured-cached" for p in again.modes)
            or again.impls != plan.impls or store.hits != t.order
            or store.misses != t.order):
        raise AssertionError("the second plan did not come from the store")
    zero_counts()
    dec_plan = fit(t, RANK, method="cp_als", plan=again, niters=NITERS,
                   state=state)
    print(f"[plan] fit with the plan {again.summary()}: launches "
          f"{read_counts()}")
    check_against_segment(dec_plan, "calibrated plan", factors_too=False)

    # --- 8. the Gram entry point: SYRK on the fitted model ------------------
    zero_counts()
    model_sq = float(kruskal_norm_sq(
        dec.lmbda, [gram(a, impl="cuda") for a in dec.factors]))
    gram_counts = read_counts()
    launches["syrk"] = gram_counts["syrk"]
    want_sq = float(kruskal_norm_sq(dec.lmbda,
                                    [gram(a) for a in dec.factors]))
    print(f"[gram] launches={gram_counts} model norm^2={model_sq:.6e}"
          f" plain={want_sq:.6e}")
    if gram_counts != dict(none, syrk=t.order):
        raise AssertionError(f"Gram path launches {gram_counts}, expected "
                             f"{t.order} SYRK and nothing else")
    if not abs(model_sq - want_sq) <= 1e-4 * abs(want_sq):
        raise AssertionError(f"model norm^2 {model_sq} vs plain {want_sq}")

    # --- 9. TTMc kernels at Kronecker width --------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    tf = tuple(torch.rand((d, r), generator=gen, device=dev)
               for d, r in zip(t.dims, TUCKER_RANKS))
    fb = tuple(a.bfloat16() for a in tf)

    def ttmc_bound(nnz_bytes: int, pnnz: int, mode: int):
        """Bound of one TTMc call: the workspace's stored entries (padding
        included, as the kernel reads them), the other factors and the
        output, against the operations the function needs for the tensor's
        non-zeros: the Kronecker row built up one factor at a time
        (val * F_1 row, then R_1 R_2 products, ... up to W) and one add per
        column, 16 + 256 + 256 = 528 flops an entry at (16, 16, 16)."""
        others = [r for m, r in enumerate(TUCKER_RANKS) if m != mode]
        width = math.prod(others)
        nbytes = (pnnz * nnz_bytes
                  + sum(t.dims[m] * TUCKER_RANKS[m] * 4
                        for m in range(t.order) if m != mode)
                  + t.dims[mode] * width * 4)
        per_entry = sum(math.prod(others[:j + 1])
                        for j in range(len(others))) + width
        ops_count = t.nnz * per_entry
        return nbytes, ops_count, *bound(nbytes, ops_count)

    k1t = totals()
    y_by_mode = {}
    for csf in csfs:
        got = ops.ttmc(csf, tf)
        err = max_err(torch, got, ref.ttmc_ref(csf, tf), rtol=1e-4,
                      atol=1e-4, what=f"K1-TTMc mode {csf.mode} float32")
        err_bf16 = max_err(torch, ops.ttmc(csf, fb),
                           ref.ttmc_ref(csf, fb).bfloat16(), rtol=5e-2,
                           atol=5e-2, what=f"K1-TTMc mode {csf.mode} bfloat16")
        ms = time_ms(torch, lambda: ops.ttmc(csf, tf))
        plain_ms = time_ms(torch, lambda: ref.ttmc_ref(csf, tf))
        nbytes, ops_count, b_ms, b_by = ttmc_bound(
            4 + 4 * (csf.order - 1) + 4, csf.padded_nnz, csf.mode)
        others = [TUCKER_RANKS[m] for m in csf.other_modes]
        gathered = gathered_bytes(csf.other_ids.unbind(1),
                                  [r * 4 for r in others])
        geo = mttkrp_cuda.ttmc_geometry(csf.padded_nnz, others)
        print(f"[K1-TTMc] mode {csf.mode} W={got.shape[1]} err f32={err:.3e}"
              f" bf16={err_bf16:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB, "
              f"{ops_count / 1e9:.2f} GFLOP); L2 gathers "
              f"{gathered / 1e9:.3f} GB at {gathered / ms / 1e6:.1f} GB/s; "
              f"{geo}")
        add_times(k1t, ms, plain_ms, nbytes, ops_count)
        k1t["max_abs_err"] = max(k1t["max_abs_err"], err)
        y_by_mode[csf.mode] = got
    k3t, k3toff = totals(), totals()
    for sm, lin in lins.items():
        got = ops.ttmc_lin(lin, tf, sm)
        err = max_err(torch, got, ref.ttmc_lin_ref(lin, tf, sm), rtol=1e-4,
                      atol=1e-4, what=f"K3-TTMc sort mode {sm} float32")
        err_k1 = max_err(torch, got, y_by_mode[sm], rtol=1e-4, atol=1e-4,
                         what=f"K3-TTMc vs K1-TTMc mode {sm}")
        err_bf16 = max_err(torch, ops.ttmc_lin(lin, fb, sm),
                           ref.ttmc_lin_ref(lin, fb, sm).bfloat16(),
                           rtol=5e-2, atol=5e-2,
                           what=f"K3-TTMc sort mode {sm} bfloat16")
        ms = time_ms(torch, lambda: ops.ttmc_lin(lin, tf, sm))
        plain_ms = time_ms(torch, lambda: ref.ttmc_lin_ref(lin, tf, sm))
        nbytes, ops_count, b_ms, b_by = ttmc_bound(12, lin.padded_nnz, sm)
        gathered = lin_gathers(lin, sm, TUCKER_RANKS)
        print(f"[K3-TTMc] sort mode {sm} err f32={err:.3e} vs "
              f"K1-TTMc={err_k1:.3e} bf16={err_bf16:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
              f"{nbytes / 1e6:.1f} MB, {ops_count / 1e9:.2f} GFLOP); L2 "
              f"gathers {gathered / 1e9:.3f} GB at "
              f"{gathered / ms / 1e6:.1f} GB/s")
        k3t["max_abs_err"] = max(k3t["max_abs_err"], err)
        if sm == 0:  # the sort mode the linearized Tucker fit runs
            add_times(k3t, ms, plain_ms, nbytes, ops_count)
        for tm in (m for m in range(t.order) if m != sm):
            got = ops.ttmc_lin(lin, tf, tm)
            what = f"off-sort TTMc sort mode {sm} mode {tm}"
            err = max_err(torch, got, ref.ttmc_lin_ref(lin, tf, tm),
                          rtol=1e-4, atol=1e-4, what=f"{what} float32")
            err_k1 = max_err(torch, got, y_by_mode[tm], rtol=1e-4,
                             atol=1e-4, what=f"{what} vs K1-TTMc")
            err_bf16 = max_err(torch, ops.ttmc_lin(lin, fb, tm),
                               ref.ttmc_lin_ref(lin, fb, tm).bfloat16(),
                               rtol=5e-2, atol=5e-2, what=f"{what} bfloat16")
            ms = time_ms(torch, lambda: ops.ttmc_lin(lin, tf, tm))
            plain_ms = time_ms(torch, lambda: ref.ttmc_lin_ref(lin, tf, tm))
            nbytes, ops_count, b_ms, b_by = ttmc_bound(12, lin.padded_nnz, tm)
            gathered = lin_gathers(lin, tm, TUCKER_RANKS)
            width = got.shape[1]
            red = atomic_runs(torch, lin.decode(tm), mttkrp_cuda.SEGMENT)
            print(f"[K3-off-TTMc] sort mode {sm} mode {tm} W={width} err "
                  f"f32={err:.3e} vs K1-TTMc={err_k1:.3e} bf16={err_bf16:.3e}"
                  f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f}"
                  f" ({b_by}, {nbytes / 1e6:.1f} MB, {ops_count / 1e9:.2f} "
                  f"GFLOP); L2 gathers {gathered / 1e9:.3f} GB at "
                  f"{gathered / ms / 1e6:.1f} GB/s; atomics {red} runs x "
                  f"{width} x 4 B = {red * width * 4 / 1e9:.3f} GB at "
                  f"{red * width * 4 / ms / 1e6:.1f} GB/s; output "
                  f"{t.dims[tm] * width * 4 / 1e6:.1f} MB")
            k3toff["max_abs_err"] = max(k3toff["max_abs_err"], err)
            if sm == 0:  # the modes the linearized Tucker fit runs
                add_times(k3toff, ms, plain_ms, nbytes, ops_count)
    del lins
    y2 = y_by_mode[2]
    svd_ms = time_ms(torch, lambda: torch.linalg.svd(y2, full_matrices=False),
                     warmup=1, reps=3)
    print(f"[svd] mode 2 Y {tuple(y2.shape)}: torch.linalg.svd ms="
          f"{svd_ms:.4f} (median of 3 after 1 warm-up)")
    del y_by_mode, y2, got

    # --- 10. the Tucker path ------------------------------------------------
    tinit = _init_orthonormal(t.dims, TUCKER_RANKS, args.seed + 4,
                              torch.float32, dev)
    tstate = make_state(tinit, {}, zero, zero, 0)
    sample = torch.randperm(t.nnz, generator=torch.Generator(device=dev)
                            .manual_seed(args.seed + 5), device=dev)[:100_000]
    sample_inds = t.inds[sample]

    def tucker_fit(impl: str, want_launches: dict[str, int]):
        """One 8-sweep timed Tucker fit from ``tstate``, launch counts set
        to 0 just before and checked just after."""
        timers: dict[str, float] = {}
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tdec = fit(t, TUCKER_RANKS, method="tucker_hooi", impl=impl,
                   niters=TUCKER_NITERS, timers=timers, state=tstate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(f"[tucker] impl={impl} fit={float(tdec.fit):.7f} "
              f"wall_s={wall:.4f} launches={counts} "
              + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                         for k in ("sort", "ttmc", "svd", "fit")))
        if counts != want_launches:
            raise AssertionError(f"tucker impl={impl} launches {counts}, "
                                 f"expected {want_launches}")
        if (tuple(tdec.core.shape) != TUCKER_RANKS
                or not torch.isfinite(tdec.core).all()
                or any(tuple(a.shape) != (d, r) or not torch.isfinite(a).all()
                       for a, d, r in zip(tdec.factors, t.dims,
                                          TUCKER_RANKS))):
            raise AssertionError(f"tucker impl={impl}: a core or factor of "
                                 "the wrong shape, or non-finite values")
        return tdec, dict(timers, wall=wall), counts

    tdec_seg, tseg_times, _ = tucker_fit("segment", dict(none))
    want_vals = tdec_seg.values_at(sample_inds)
    # the singular-value gap at the rank cut of each mode's final Y: what
    # decides how well the subspaces are defined
    sigma_gap = []
    for m, csf in enumerate(csfs):
        sv = torch.linalg.svdvals(ops.ttmc(csf, tdec_seg.factors))
        r = TUCKER_RANKS[m]
        sigma_gap.append((float(sv[r - 1]), float(sv[r])))
    print("[tucker] segment sigma_R, sigma_R+1 per mode: "
          + " ".join(f"({a:.6e}, {b:.6e})" for a, b in sigma_gap))

    def check_tucker(tdec, what: str, want=None, against: str = "segment",
                     tag: str = "tucker") -> None:
        """Hold ``tdec`` to a Tucker fit (phase 10's ``segment`` unless
        ``want`` is given) at the Tucker limits."""
        want = tdec_seg if want is None else want
        wv = want_vals if want is tdec_seg else want.values_at(sample_inds)
        fit_diff = abs(float(tdec.fit) - float(want.fit))
        got_vals = tdec.values_at(sample_inds)
        vals_rel = float(torch.linalg.norm(got_vals - wv)
                         / torch.linalg.norm(wv))
        gaps = [subspace_gap(torch, a, b)
                for a, b in zip(tdec.factors, want.factors)]
        print(f"[{tag}] {what} vs {against} fit={float(want.fit):.7f} "
              f"|diff|={fit_diff:.3e} values rel={vals_rel:.3e} max abs="
              f"{float((got_vals - wv).abs().max()):.3e} subspace="
              + " ".join(f"{g:.3e}" for g in gaps))
        if not math.isfinite(float(tdec.fit)) or fit_diff > 1e-5:
            raise AssertionError(f"{what}: fit {float(tdec.fit)} vs "
                                 f"{against} {float(want.fit)}")
        if vals_rel > 1e-3 or max(gaps) > 1e-3:
            raise AssertionError(f"{what}: values or a subspace differ from "
                                 f"{against}'s by more than 1e-3")

    tdec, tcsf_times, tlaunches = tucker_fit(
        "cuda", dict(none, ttmc=t.order * TUCKER_NITERS))
    check_tucker(tdec, "impl=cuda")
    launches["ttmc"] = tlaunches["ttmc"]

    # --- 11. the linearized Tucker path ---------------------------------------
    tdec_lin, tlin_times, tlin_launches = tucker_fit(
        "linearized_cuda", dict(none, ttmc_lin=TUCKER_NITERS,
                                ttmc_off_sort=(t.order - 1) * TUCKER_NITERS))
    check_tucker(tdec_lin, "impl=linearized_cuda")
    for name in ("ttmc_lin", "ttmc_off_sort"):
        launches[name] = tlin_launches[name]
    print("[tucker] routine s (cuda | linearized_cuda | segment): "
          + " ".join(f"{k}={tcsf_times[k]:.4f}|{tlin_times[k]:.4f}|"
                     f"{tseg_times[k]:.4f}"
                     for k in ("sort", "ttmc", "svd", "fit", "wall")))

    # --- 12. the ingested path ----------------------------------------------
    import repro_torch.core.csf as csf_mod
    import repro_torch.core.linearized as lin_mod
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ingest import ingest, read_tnsb, write_tnsb

    builds = {"build_csf": 0, "build_linearized": 0}
    real_builds = {"build_csf": csf_mod.build_csf,
                   "build_linearized": lin_mod.build_linearized}

    def counted_build(name):
        def build(*a, **k):
            builds[name] += 1
            return real_builds[name](*a, **k)
        return build

    def step(what: str, seconds: float) -> None:
        print(f"[ingest] {what} s={seconds:.4f} on {card}")

    def sync_time(fn):
        """``(fn(), seconds)``, the card synchronised before and after."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="ingest-") as work:
        work = Path(work)
        path, cache = work / "yelp.tnsb", work / "cache"
        _, write_s = sync_time(lambda: write_tnsb(path, t))
        step(f"write_tnsb ({path.stat().st_size / 1e6:.1f} MB)", write_s)
        back, read_s = sync_time(lambda: read_tnsb(path, device=dev))
        step("read_tnsb", read_s)
        if (back.dims != t.dims or back.nnz != t.nnz
                or not torch.equal(back.inds, t.inds[: t.nnz])
                or not torch.equal(back.vals, t.vals[: t.nnz])):
            raise AssertionError("read_tnsb did not give back the tensor")
        del back

        csf_mod.build_csf = counted_build("build_csf")
        lin_mod.build_linearized = counted_build("build_linearized")
        try:
            cold, cold_s = sync_time(lambda: ingest(
                path, reorder="degree_sort", cache=cache, device=dev))
            cold_builds = dict(builds)
            step(f"cold ingest (degree_sort, linearized mode "
                 f"{cold.relabeling.linearized_mode}; builds {cold_builds})",
                 cold_s)
            del cold
            builds.update(dict.fromkeys(builds, 0))
            ing, warm_s = sync_time(lambda: ingest(
                path, reorder="degree_sort", cache=cache, device=dev))
            step(f"warm ingest (cache_hit={ing.cache_hit}, builds "
                 f"{builds})", warm_s)
        finally:
            csf_mod.build_csf = real_builds["build_csf"]
            lin_mod.build_linearized = real_builds["build_linearized"]
        if cold_builds != {"build_csf": t.order, "build_linearized": 1}:
            raise AssertionError(f"cold ingest builds {cold_builds}")
        if not ing.cache_hit or any(builds.values()):
            raise AssertionError(f"warm ingest: cache_hit={ing.cache_hit}, "
                                 f"builds {builds}")

        store = ing.cache.autotune
        iplan, plan1_s = sync_time(lambda: ing.plan("auto", rank=RANK,
                                                    calibrate=True))
        step(f"first calibrated plan {iplan.summary()} sources "
             f"{[p.source for p in iplan.modes]}", plan1_s)
        hits, misses = store.hits, store.misses
        iplan2, plan2_s = sync_time(lambda: ing.plan("auto", rank=RANK,
                                                     calibrate=True))
        step(f"warm plan {iplan2.summary()} hits={store.hits - hits} "
             f"misses={store.misses - misses}", plan2_s)
        if (any(p.source != "measured-cached" for p in iplan2.modes)
                or iplan2.impls != iplan.impls
                or store.hits - hits != t.order or store.misses != misses):
            raise AssertionError("the warm plan made a timing run")

        # HALS on the cached workspaces, from one nonnegative state
        hstate = make_state(ing.relabeling.apply_factors(init), {}, zero,
                            zero, 0)

        def hals_fit(impl: str, want_launches: dict[str, int]):
            timers: dict[str, float] = {}
            zero_counts()
            hdec, wall = sync_time(lambda: fit(
                ing, RANK, method="cp_nn_hals", impl=impl, niters=NITERS,
                timers=timers, state=hstate))
            counts = read_counts()
            print(f"[hals] impl={impl} fit={float(hdec.fit):.7f} "
                  f"wall_s={wall:.4f} launches={counts} "
                  + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                             for k in ROUTINES_FUSED) + f" on {card}")
            if counts != want_launches:
                raise AssertionError(f"hals impl={impl} launches {counts}, "
                                     f"expected {want_launches}")
            for m, a in enumerate(hdec.factors):
                if (tuple(a.shape) != (t.dims[m], RANK)
                        or not torch.isfinite(a).all() or a.min() < 0):
                    raise AssertionError(f"hals impl={impl} factor {m}: "
                                         "shape, non-finite or negative")
            return hdec

        hseg = hals_fit("segment", dict(none))
        check_against_segment(
            hals_fit("cuda", dict(none, mttkrp=t.order * NITERS)),
            "hals impl=cuda", want=hseg, tag="hals")
        check_against_segment(
            hals_fit("linearized_cuda",
                     dict(none, mttkrp_lin=NITERS,
                          mttkrp_off_sort=(t.order - 1) * NITERS)),
            "hals impl=linearized_cuda", want=hseg, tag="hals")

        # CP-ALS on the warm handle: no Sort; factors back in the tensor's
        # labels, held to phase 5's segment fit of the tensor itself
        wstate = CPALSState(ing.relabeling.apply_factors(init),
                            state.lmbda, zero, zero, state.iteration)
        timers = {}
        zero_counts()
        wdec, wall = sync_time(lambda: fit(
            ing, RANK, impl="cuda", niters=NITERS, timers=timers,
            fused_epilogue=True, state=wstate))
        print(f"[ingest] warm cuda fit={float(wdec.fit):.7f} wall_s="
              f"{wall:.4f} launches={read_counts()} "
              + " ".join(f"{k}_s={timers.get(k, 0.0):.4f}"
                         for k in ROUTINES_FUSED)
              + f" (phase 5's sort_s={csf_times['sort']:.4f}) on {card}")
        check_against_segment(wdec, "warm handle impl=cuda", tag="ingest")

        # checkpoint at every iteration of a 10-iteration run, then a fresh
        # manager restores the newest and a new fit resumes it to 20
        ckpt = CheckpointManager(work / "ckpt", keep=2)
        (_, ck_s) = sync_time(lambda: fit(
            ing, RANK, impl="cuda", niters=NITERS // 2, state=wstate,
            checkpoint_cb=lambda s: ckpt.save(int(s.iteration), s)))
        ckpt.wait()
        like = make_state(wstate.factors, {"lmbda": wstate.lmbda}, zero,
                          zero, 0)
        restored, extra = CheckpointManager(work / "ckpt").restore(like)
        zero_counts()
        rdec, resume_s = sync_time(lambda: fit(
            ing, RANK, impl="cuda", niters=NITERS, state=restored))
        step(f"checkpointed {NITERS // 2} iterations ({ck_s:.4f} s), "
             f"restored step {extra['step']} onto "
             f"{restored.factors[0].device}, resumed to {NITERS} "
             f"(launches {read_counts()['mttkrp']})", resume_s)
        if (extra["step"] != NITERS // 2
                or restored.factors[0].device.type != dev.type):
            raise AssertionError("the checkpoint did not restore onto the "
                                 "card at the last step")
        check_against_segment(rdec, "resumed", want=wdec, tag="ingest",
                              against="uninterrupted")

        # --- 13. streaming: the .tnsb one chunk at a time ------------------
        sstate = make_state(init, {"lmbda": state.lmbda}, zero, zero, 0)
        zero_counts()
        sdec, stream_s = sync_time(lambda: fit(
            path, RANK, method="cp_als_streaming", niters=STREAM_NITERS,
            state=sstate, device=dev))
        bdec = fit(ing, RANK, impl="segment", niters=STREAM_NITERS,
                   state=wstate)
        diff = abs(float(sdec.fit) - float(bdec.fit))
        print(f"[stream] {STREAM_NITERS} iterations, "
              f"{-(-t.nnz // (1 << 20))} chunks of 2^20: fit="
              f"{float(sdec.fit):.7f} batch segment fit="
              f"{float(bdec.fit):.7f} |diff|={diff:.3e} wall_s="
              f"{stream_s:.4f} launches={read_counts()} on {card}")
        if not math.isfinite(float(sdec.fit)) or diff > 1e-3:
            raise AssertionError(f"streamed fit {float(sdec.fit)} vs batch "
                                 f"{float(bdec.fit)}")
        del hseg, wdec, rdec, sdec, bdec

        # --- 14. the front door: the CLI, Session, trace, serve ----------
        front_s, ssess = front_door(torch, work, path, cache, ing, t,
                                    sample_inds, card, none, zero_counts,
                                    read_counts, check_against_segment,
                                    check_tucker)

        # --- 15. serving: graphs per bucket, the server, the daemons ------
        serve_s = serving(torch, path, cache, ssess, sample_inds, card,
                          none, zero_counts, read_counts)
        ssess.close()
        del ssess

        # --- 16. the dist executor on a one-rank NCCL group ---------------
        dist_s, dist_iteration = distributed(
            torch, ing, card, none, zero_counts, read_counts,
            check_against_segment)
        del ing

    # --- 17. the decomposition launcher: serve_cpd on full yelp -----------
    launch_s = launcher(torch, dev, card, none, zero_counts, read_counts,
                        check_against_segment)

    # --- 18. LM serving: llama3.2-3b at full width ------------------------
    lm_s = lm_serving(torch, dev, card, args.seed)

    # --- 19. the other LM families at their published widths -------------
    families_s = lm_families(torch, dev, card, args.seed)

    # --- 20. LM training: llama3.2-3b at full width ------------------------
    train_s = lm_training(torch, dev, card, args.seed)

    # --- 21. the production mesh's path on one card ---------------------
    mesh_s, mesh_step_s = lm_mesh(torch, dev, card, args.seed)

    # --- 22. the dry-run on fake 256/512-rank groups, and its bounds ------
    dryrun_s = dry_run(card, mesh_step_s, dist_iteration)

    # --- 23. results --------------------------------------------------------
    kernels = [
        kernel_entry("mttkrp", "segmented.cuh",
                     "src/repro/kernels/mttkrp_pallas.py:49",
                     launches["mttkrp"], k1),
        kernel_entry("syrk", "syrk.cu", "src/repro/kernels/syrk_pallas.py:24",
                     launches["syrk"], k2),
        kernel_entry("mttkrp_lin", "segmented.cuh",
                     "src/repro/kernels/linearized_pallas.py:34",
                     launches["mttkrp_lin"], k3),
        kernel_entry("ttmc", "segmented.cuh",
                     "src/repro/kernels/mttkrp_pallas.py:49",
                     launches["ttmc"], k1t,
                     caller="src/repro/kernels/ops.py:77"),
        kernel_entry("ttmc_lin", "segmented.cuh",
                     "src/repro/kernels/linearized_pallas.py:34",
                     launches["ttmc_lin"], k3t,
                     caller="src/repro/kernels/ops.py:158"),
        kernel_entry("mttkrp_off_sort", "segmented.cuh",
                     "src/repro/core/mttkrp.py:239",
                     launches["mttkrp_off_sort"], k3off),
        kernel_entry("ttmc_off_sort", "segmented.cuh",
                     "src/repro/core/ttmc.py:157",
                     launches["ttmc_off_sort"], k3toff),
    ]
    print(f"[note] build {build_s:.3f} s; times: one call for each mode the "
          "main path runs, summed (mttkrp_lin and ttmc_lin: sort mode 0; "
          "mttkrp_off_sort and ttmc_off_sort: modes 1 and 2 of sort mode "
          "0); launches: mttkrp in fit(impl='cuda'), mttkrp_lin and "
          "mttkrp_off_sort in fit(impl='linearized_cuda'), syrk in "
          "gram(impl='cuda'), ttmc, ttmc_lin and ttmc_off_sort in the Tucker "
          "fits of the same impls")
    print(f"[front] the front-door phase ran {front_s:.1f} s on {card}")
    print(f"[serve] the serving phase ran {serve_s:.1f} s on {card}")
    print(f"[dist] the distributed phase ran {dist_s:.1f} s on {card}")
    print(f"[launch] the launcher phase ran {launch_s:.1f} s on {card}")
    print(f"[lm] the LM serving phase ran {lm_s:.1f} s on {card}")
    print(f"[families] the LM families phase ran {families_s:.1f} s on "
          f"{card}")
    print(f"[train] the LM training phase ran {train_s:.1f} s on {card}")
    print(f"[mesh] the mesh phase ran {mesh_s:.1f} s on {card}")
    print(f"[dryrun] the dry-run phase ran {dryrun_s:.1f} s on {card}'s "
          f"host")
    print(f"[total] chip_smoke.py ran {time.perf_counter() - start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
