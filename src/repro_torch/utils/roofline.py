"""Three-term roofline of a traced dry-run step, for one NVIDIA H100
(counterpart of ``repro.utils.roofline``).

  compute term    = bf16_flops / BF16_FLOPS + fp32_flops / FP32_FLOPS
  memory term     = bytes_per_rank / HBM_BW
  collective term = nvlink_wire / NVLINK_BW + ib_wire / IB_BW

The counts are one rank's: ``repro_torch.launch.dryrun`` traces one step
of rank 0 over a fake process group of the grid's size, on meta-device
DTensors, and records one collective record per ``torch.distributed`` or
functional-collective call: its kind, its result bytes on the rank and
its group's size.  :func:`collectives_of` turns the records into ring
wire bytes with the reference's model, word for word:

  all-reduce       2 * B * (g-1)/g        (B = per-rank block bytes)
  all-gather       B_out * (g-1)/g        (B_out = gathered result bytes)
  reduce-scatter   B_out * (g-1)          (B_out = scattered result bytes)
  all-to-all       B * (g-1)/g
  collective-perm  B

The links are two levels, as on a DGX H100 cluster: a group whose ranks
all sit in one 8-GPU node (consecutive ranks, 8 a node) rides NVLink 4,
any other group InfiniBand NDR through the rank's own NIC.  Products in
bfloat16 or float16 count at the tensor cores' dense rate; every other
flop (float32 products, which the CP path runs with TF32 off, and every
pointwise or reduction op) at the float32 rate.

The reference's ``parse_collectives`` reads XLA's HLO text, which the port
never has; :func:`collectives_of` gives the same dicts from the records.
Its ``normalize_cost``, ``CompatCompiled``, ``CompatLowered`` and
``analyze`` are shims around JAX's compiled objects and have no
counterpart.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable

# NVIDIA H100 80GB HBM3, 700 W (H100 SXM data sheet), dense, no sparsity
BF16_FLOPS = 989.4e12   # bf16 / fp16 tensor-core products, FLOP/s
FP32_FLOPS = 66.9e12    # float32, FLOP/s
HBM_BW = 3.35e12        # bytes/s
# NVIDIA H100 80GB HBM3, 700 W (H100 SXM data sheet; DGX H100: 8 GPUs a
# node on NVLink 4, one InfiniBand NDR 400 Gb/s NIC a GPU)
NVLINK_BW = 450e9       # bytes/s a GPU, each direction
IB_BW = 50e9            # bytes/s a GPU
NODE_RANKS = 8

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, b: float, g: int) -> float:
    """Ring-algorithm wire bytes a rank sends for one collective of
    ``kind`` whose result on the rank is ``b`` bytes, over ``g`` ranks."""
    g = max(1, g)
    if kind == "all-reduce":
        wire = 2.0 * b * (g - 1) / g
    elif kind == "all-gather":
        wire = b * (g - 1) / g
    elif kind == "reduce-scatter":
        wire = b * (g - 1)
    elif kind == "all-to-all":
        wire = b * (g - 1) / g
    elif kind == "collective-permute":
        wire = float(b)
    else:
        raise ValueError(f"unknown collective kind {kind!r}; one of {KINDS}")
    return wire


def in_one_node(ranks: Iterable[int]) -> bool:
    """Whether every rank of a group sits in one ``NODE_RANKS``-GPU node."""
    ranks = list(ranks)
    return min(ranks) // NODE_RANKS == max(ranks) // NODE_RANKS


def collectives_of(records: Iterable) -> list[dict]:
    """One dict a collective record, the reference's ``parse_collectives``
    keys: ``kind``, ``bytes`` (result bytes on the rank), ``group`` (its
    size) and ``wire`` (ring wire bytes), and ``link`` (``"nvlink"`` or
    ``"ib"``).  A record is ``(kind, bytes, group)`` or ``(kind, bytes,
    group, ranks)``; without the group's ranks the link is InfiniBand."""
    out = []
    for rec in records:
        kind, b, g = rec[:3]
        ranks = rec[3] if len(rec) > 3 else None
        g = max(1, int(g))
        link = "nvlink" if ranks is not None and in_one_node(ranks) else "ib"
        out.append({"kind": kind, "bytes": b, "group": g,
                    "wire": wire_bytes(kind, b, g), "link": link})
    return out


def collective_summary(colls: list[dict]) -> dict:
    agg: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0.0,
                                                "wire": 0.0})
    for c in colls:
        a = agg[c["kind"]]
        a["count"] += 1
        a["bytes"] += c["bytes"]
        a["wire"] += c["wire"]
    return dict(agg)


def nvlink_wire(colls: list[dict]) -> float:
    """The wire bytes of the collectives that stay inside one node."""
    return sum(c["wire"] for c in colls if c["link"] == "nvlink")


@dataclasses.dataclass
class Roofline:
    flops: float                 # per rank
    bytes_accessed: float        # per rank
    wire_bytes: float            # per rank
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # global 6ND (or 2ND serve)
    useful_ratio: float          # model_flops / (flops * ranks)
    collectives: dict
    bound_s: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze_values(*, flops: float, bytes_accessed: float, wire_bytes: float,
                   collectives: dict, n_chips: int, model_flops: float,
                   bf16_flops: float, nvlink_wire: float) -> Roofline:
    """The roofline of one rank's counts.  ``flops`` is the total, of which
    ``bf16_flops`` count at the tensor cores' rate and the rest at the
    float32 rate; ``wire_bytes`` the total, of which ``nvlink_wire`` stays
    inside a node and the rest crosses InfiniBand."""
    compute_s = bf16_flops / BF16_FLOPS + (flops - bf16_flops) / FP32_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = (nvlink_wire / NVLINK_BW
                    + (wire_bytes - nvlink_wire) / IB_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / max(flops * n_chips, 1.0)
    return Roofline(
        flops=flops, bytes_accessed=bytes_accessed, wire_bytes=wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        collectives=collectives, bound_s=max(terms.values()),
    )


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for serving
    (D = tokens processed by the step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens
