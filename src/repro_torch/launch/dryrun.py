"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell, and
each ``cpals-*`` workload's distributed iteration, as rank 0 of a fake
process group of the production world size (256 ranks single pod, 512
multi pod), on ``meta``-device DTensors; count the rank's flops, bytes and
collectives, estimate its memory, and give the three-term H100 roofline
(counterpart of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # full matrix
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch cpals-yelp [--mesh multi]

The fake group (``torch.distributed``'s ``"fake"`` backend on a
``FakeStore``) is process-global and cannot live beside the NCCL or gloo
group of a run, so only :func:`main` starts it; :func:`run_all` runs one
subprocess a cell, and the front door's ``dryrun`` re-execs this module.
Nothing is launched on a card and nothing falls back: a grid that cannot
be made, a leaf that cannot be placed, or an op without a ``meta`` kernel
raises.  The grid's ``DeviceMesh`` names ``"cuda"`` so that DTensor takes
the card's collectives (an all-to-all, not gloo's all-gather).

What :class:`StepTrace` counts over one traced step, for rank 0 (the local
shards: it lets DTensor desugar each op into its local ops and
collectives before it counts):

  * flops: the product formulas of ``torch.utils.flop_counter`` (split into
    bf16/fp16 products and the rest), one flop per output element of each
    pointwise op, and one per element reduced by a reduction or a
    scatter-add (``index_add_``, ``segment_reduce``, ...), which the
    product formulas alone never see;
  * bytes: each op's input and output bytes, unfused (views move nothing;
    a broadcast input counts its distinct elements; a gather reads at
    most its output's worth of the source): an upper bound of XLA's fused
    ``bytes accessed``;
  * collectives: one record per ``c10d`` call (``torch.distributed``, as
    ``dist.collectives`` and ``moe_ffn_ep`` call it) or functional
    collective (DTensor's redistributions), with its kind, its result
    bytes on the rank, its group's size and ranks;
  * memory: the peak of the storages the step allocates and frees (each
    storage's finaliser), the step's outputs aside.

The LM cells keep the reference's depth probes: a step is traced at k = 1
and k = 2 repetitions of the layer pattern and every count, the memory's
included, is extrapolated to full depth (a stacked leaf's bytes are linear
in the reps, so ``argument_bytes`` is exact).  The parameters, the
optimizer state and the cache are updated in place (the counterpart of
donation): they are outputs that alias arguments.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import weakref
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.launch.mesh import (batch_sharding, install,
                                     make_production_mesh, place,
                                     place_model, rules_for, sharding_fn,
                                     uninstall)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import Model
from repro_torch.models.config import SHAPES, ShapeConfig, cell_is_skipped
from repro_torch.models.params import ParamSpec, axes_tree
from repro_torch.optim import OPTIMIZERS
from repro_torch.utils import roofline as RL

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# per-arch optimizer (Adafactor where AdamW state cannot fit the mesh)
ARCH_OPT = {"kimi-k2-1t-a32b": "adafactor"}

# a cell's process may map this much: DTensor's shard arithmetic builds
# host index tensors a global dim long, and a cell that asks for more
# fails with an allocation error instead of exhausting its host
HOST_BYTES = 16 << 30


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------

def init_fake_group(world: int) -> None:
    """Start the process-global fake group of ``world`` ranks, this process
    rank 0; a fake group of that size already there is kept, any other
    group raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"the dry-run needs a fake process group of {world} ranks; "
                f"this process has a {dist.get_backend()!r} group of "
                f"{dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

_ATEN = torch.ops.aten
# reads of a source at indices: at most the output's worth of it is read
_GATHERS = {_ATEN.index.Tensor, _ATEN.index_select.default,
            _ATEN.gather.default, _ATEN.embedding.default}
# in-place scatters: the touched rows of ``self``, at most the source's
# worth, are read and written; the source's arg index
_SCATTERS_INPLACE = {_ATEN.index_add_.default: 3,
                     _ATEN.scatter_add_.default: 3,
                     _ATEN.index_put_.default: 2,
                     _ATEN._index_put_impl_.default: 2}
# reductions the tags do not mark: the reduced operand's arg index
_REDUCTIONS = {_ATEN.index_add.default: 3, _ATEN.scatter_add.default: 3,
               _ATEN.index_put.default: 2,
               _ATEN.segment_reduce.default: 0,
               _ATEN.embedding_dense_backward.default: 0}
# the index_put family reduces only with ``accumulate`` (arg 3)
_PUTS = {_ATEN.index_put_.default, _ATEN._index_put_impl_.default,
         _ATEN.index_put.default}
# writes only: the destination is not read
_WRITES_ONLY = {_ATEN.copy_.default, _ATEN.fill_.Scalar, _ATEN.zero_.default}
# allocation without a write
_NO_DATA = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
            _ATEN.new_empty.default, _ATEN.new_empty_strided.default,
            _ATEN.empty_like.default, _ATEN._unsafe_view.default,
            _ATEN.lift_fresh.default}
_LOW_PRECISION = (torch.bfloat16, torch.float16)

# collective op name -> reference kind; for a c10d op the result is its
# first argument (written in place), for a functional one its return
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor")
# ops of those namespaces that move no data between ranks
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _tensors(x):
    """The plain tensors in an argument (lists and tuples walked)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor spans: a broadcast
    (stride-0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _is_view(func) -> bool:
    return func.is_view or func in _NO_DATA or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


def _is_inplace(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)


class StepTrace(TorchDispatchMode):
    """Counts one rank's flops, bytes, collectives and allocations over
    the ops it sees (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.bf16_flops = 0.0
        self.flops = 0.0
        self.bytes = 0.0
        self.records: list[tuple] = []
        self._groups: dict = {}
        self._events: list[tuple[int, int]] = []
        self._live: dict[int, int] = {}
        self._serial = 0

    # -- the dispatch ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor desugars the op into local ops and collectives,
            # which come back here: the rank's own counts
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None or not any(
                t.is_meta for t in _tensors((out, args, tuple(
                    kwargs.values())))):
            # DTensor's sharding propagation runs the op on fake global
            # tensors (once a shape), and its shard arithmetic on small
            # host tensors: no work of the step, which is all on meta (a
            # c10d call may return only its work handle)
            return out
        if func.namespace in _COLLECTIVE_NS:
            if self._collective(func, args, kwargs, out):
                self._allocated(out)
        elif not _is_view(func):
            self._count(func, args, kwargs, out)
            if not _is_inplace(func):
                self._allocated(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins = [t for a in (*args, *kwargs.values()) for t in _tensors(a)]
        outs = list(_tensors(out))
        packet = func.overloadpacket
        if packet in self._formulas:
            f = float(self._formulas[packet](*args, **kwargs, out_val=out))
            self.flops += f
            if ins and ins[0].dtype in _LOW_PRECISION:
                self.bf16_flops += f
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif func in _PUTS:
            if (args[3] if len(args) > 3 else kwargs.get("accumulate")):
                self.flops += args[2].numel()
        elif func in _SCATTERS_INPLACE:
            self.flops += args[_SCATTERS_INPLACE[func]].numel()
        elif func in _REDUCTIONS:
            self.flops += args[_REDUCTIONS[func]].numel()
        elif torch.Tag.reduction in func.tags and ins:
            self.flops += ins[0].numel()

        out_b = sum(_distinct_bytes(t) for t in outs)
        if func in _GATHERS:
            src = _distinct_bytes(args[0])
            in_b = min(src, out_b) + sum(
                _distinct_bytes(t) for a in args[1:] for t in _tensors(a))
        elif func in _SCATTERS_INPLACE:
            touched = min(_distinct_bytes(args[0]),
                          _distinct_bytes(args[_SCATTERS_INPLACE[func]]))
            in_b = touched + sum(_distinct_bytes(t) for a in args[1:]
                                 for t in _tensors(a))
            out_b = touched
        elif func in _WRITES_ONLY:
            in_b = sum(_distinct_bytes(t) for a in args[1:]
                       for t in _tensors(a))
        else:
            in_b = sum(_distinct_bytes(t) for t in ins)
        self.bytes += in_b + out_b

    # -- collectives ----------------------------------------------------
    def _collective(self, func, args, kwargs, out) -> bool:
        """Record a collective; whether it returns a new tensor."""
        name = func._schema.name.split("::")[-1]
        if name in _NOT_COLLECTIVES:
            return False
        if name not in _COLLECTIVES:
            raise NotImplementedError(
                f"the dry-run does not count the collective {func}")
        kind = _COLLECTIVES[name]
        result = args[0] if func.namespace == "c10d" else out
        pg = self._group_of(func, args, kwargs)
        key = id(pg)
        if key not in self._groups:
            self._groups[key] = (pg, tuple(dist.get_process_group_ranks(pg)))
        ranks = self._groups[key][1]
        self.records.append((kind, _nbytes(result), len(ranks), ranks))
        return func.namespace != "c10d" and not _is_inplace(func)

    @staticmethod
    def _group_of(func, args, kwargs):
        from torch.distributed.distributed_c10d import _resolve_process_group

        schema = func._schema.arguments
        for i, arg in enumerate(schema):
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            if "ProcessGroup" in str(arg.type):
                return torch._C._distributed_c10d.ProcessGroup.unbox(val)
            if arg.name == "group_name":
                return (val if not isinstance(val, str)
                        else _resolve_process_group(val))
        raise NotImplementedError(f"no process group in {func}")

    # -- memory ---------------------------------------------------------
    def _allocated(self, out) -> None:
        for t in _tensors(out):
            s = t.untyped_storage()
            if s._cdata in self._live:
                continue
            self._serial += 1
            self._live[s._cdata] = self._serial
            self._events.append((self._serial, s.nbytes()))
            weakref.finalize(s, self._freed, s._cdata, self._serial,
                             s.nbytes())

    def _freed(self, cdata: int, serial: int, nbytes: int) -> None:
        if self._live.get(cdata) == serial:
            del self._live[cdata]
        self._events.append((serial, -nbytes))

    def temp_bytes(self, outputs) -> int:
        """Peak bytes of the storages the step allocated, those of
        ``outputs`` (still alive) aside."""
        skip = {self._live.get(t.untyped_storage()._cdata)
                for t in _local_tensors(outputs)}
        cur = peak = 0
        for serial, delta in self._events:
            if serial in skip:
                continue
            cur += delta
            peak = max(peak, cur)
        return peak


def _local_tensors(tree):
    """The local tensors of a tree of tensors and DTensors (dicts, lists,
    tuples and dataclasses walked)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _local_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _local_tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _local_tensors(getattr(tree, f.name))


def _storage_bytes(tree, seen: set) -> int:
    """Local bytes of a tree's storages not in ``seen`` (which grows)."""
    total = 0
    for t in _local_tensors(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


@dataclasses.dataclass
class Step:
    """One step to trace: ``fn(*args)``, which also reads ``params`` (the
    model's, which it holds); ``inplace`` are the trees it updates in
    place (outputs that alias arguments)."""

    fn: Callable
    args: tuple
    params: Any = None
    inplace: tuple = ()


def trace(step: Step) -> dict:
    """Run ``step`` once under :class:`StepTrace`: the rank's counts, its
    collective records and its memory."""
    t0 = time.perf_counter()
    mode = StepTrace()
    with mode:
        result = step.fn(*step.args)
    seconds = time.perf_counter() - t0
    seen: set = set()
    argument = _storage_bytes((step.params, step.args), seen)
    inplace = _storage_bytes(step.inplace, set())
    fresh = _storage_bytes(result, seen)
    memory = {"argument_bytes": argument,
              "output_bytes": inplace + fresh,
              "temp_bytes": mode.temp_bytes(result),
              "alias_bytes": inplace}
    colls = RL.collectives_of(mode.records)
    return {"flops": mode.flops, "bf16_flops": mode.bf16_flops,
            "bytes": mode.bytes, "wire": sum(c["wire"] for c in colls),
            "nvlink_wire": RL.nvlink_wire(colls),
            "summary": RL.collective_summary(colls), "memory": memory,
            "trace_s": seconds}


def _memory(mem: dict) -> dict:
    mem = {k: int(round(v)) for k, v in mem.items()}
    mem["peak_estimate_gib"] = round(
        (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
         - mem["alias_bytes"]) / 2**30, 3)
    return mem


def _roofline(counts: dict, n_chips: int, model_flops: float):
    return RL.analyze_values(
        flops=counts["flops"], bytes_accessed=counts["bytes"],
        wire_bytes=counts["wire"], collectives=counts["summary"],
        n_chips=n_chips, model_flops=model_flops,
        bf16_flops=counts["bf16_flops"], nvlink_wire=counts["nvlink_wire"])


def _split(counts: dict) -> dict:
    """The compute and collective terms' split, beside the roofline."""
    return {"bf16_flops": counts["bf16_flops"],
            "fp32_flops": counts["flops"] - counts["bf16_flops"],
            "nvlink_wire": counts["nvlink_wire"],
            "ib_wire": counts["wire"] - counts["nvlink_wire"]}


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------

def _placed(shape, dtype, sh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             sh.device_mesh, sh.placements)


def abstract_cache(model: Model, mesh, rules, batch, cache_len, *, src_len=0,
                   cdtype):
    """The cache on ``meta``, each leaf a DTensor placed by its logical
    axes: ``slot_pos`` int32, the recurrent ``state`` and ``h`` float32,
    the rest ``cdtype``."""
    specs = model.cache_specs(batch, cache_len, src_len=src_len)
    sfn = sharding_fn(mesh, rules)

    def walk(tree):
        out = {}
        for name, s in tree.items():
            if not isinstance(s, ParamSpec):
                out[name] = walk(s)
                continue
            if name == "slot_pos":
                dt = torch.int32
            elif name in ("state", "h"):
                dt = torch.float32
            else:
                dt = cdtype
            out[name] = _placed(s.shape, dt, sfn(s.axes, s.shape))
        return out

    return walk(specs)


def _configured(arch: str, overrides: dict | None):
    """The arch's ModelConfig with its overrides, the rule overrides and
    the step builder's keywords (keys 'rules:...' and 'steps:...')."""
    overrides = overrides or {}
    cfg_ov = {k: v for k, v in overrides.items()
              if not k.startswith(("rules:", "steps:"))}
    rule_ov = {k[6:]: v for k, v in overrides.items()
               if k.startswith("rules:")}
    step_kw = {k[6:]: v for k, v in overrides.items()
               if k.startswith("steps:")}
    cfg = configs.get(arch)
    if cfg_ov:
        cfg = dataclasses.replace(cfg, **cfg_ov)
    return cfg, rule_ov, step_kw


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               overrides: dict | None = None, mesh=None,
               shape: ShapeConfig | None = None):
    """Returns (step, meta) for one cell, the model placed on the grid and
    the activation hook installed (:func:`uninstall` after the trace).
    Override keys starting with 'rules:' go to the sharding rules,
    'steps:' to the step builder, the rest to the ModelConfig; ``shape``
    replaces ``SHAPES[shape_name]``."""
    cfg, rule_ov, step_kw = _configured(arch, overrides)
    shape = SHAPES[shape_name] if shape is None else shape
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
    rules = rules_for(cfg, multi_pod=multi_pod, overrides=rule_ov or None)
    sfn = sharding_fn(mesh, rules)
    model = place_model(Model(cfg), sfn)
    # activation sharding (keeps flash/MoE internals sharded)
    install(mesh, rules)

    batch = {k: _placed(sh, dt, batch_sharding(mesh, rules, kind, sh))
             for k, (sh, dt, kind) in configs.batch_shapes(cfg, shape).items()}
    meta = {"arch": arch, "shape": shape.name, "mesh": mesh.shape,
            "n_chips": mesh.axis_size(mesh.axis_names),
            "fsdp": cfg.fsdp, "optimizer": None}
    params = model.params()

    if shape.kind == "train":
        opt_name = ARCH_OPT.get(arch, "adamw")
        meta["optimizer"] = opt_name
        optimizer = OPTIMIZERS[opt_name]()
        opt_state = place(optimizer.init(params),
                          optimizer.state_axes(axes_tree(model.param_specs())),
                          sfn)
        fn = make_train_step(model, optimizer, **step_kw)
        return Step(fn, (opt_state, batch, 0), params=params,
                    inplace=(params, opt_state)), meta

    src = configs.src_len(cfg, shape) if cfg.encdec else 0
    cache = abstract_cache(model, mesh, rules, shape.global_batch,
                           shape.seq_len, src_len=src, cdtype=cfg.cdtype)
    if shape.kind == "prefill":
        fn = make_prefill_step(model)
        return Step(fn, (batch, cache), params=params,
                    inplace=(cache,)), meta

    # decode: one token at the cache's last position
    fn = make_serve_step(model)
    return Step(fn, (batch["tokens"], cache, shape.seq_len - 1,
                     batch.get("positions")), params=params,
                inplace=(cache,)), meta




def _probe_costs(arch: str, shape: ShapeConfig, *, multi_pod: bool,
                 overrides: dict | None, cfg, mesh) -> dict:
    """Trace k=1 / k=2 repetitions of the layer pattern; extrapolate every
    count, the memory's included, to full depth."""
    prefix, reps, suffix = cfg.layer_plan
    t0 = time.time()
    results = []
    for k in (1, 2):
        ov = dict(overrides or {})
        ov.update(
            num_layers=len(prefix) + k * len(cfg.pattern) + len(suffix),
            enc_layers=(k if cfg.encdec else 0),
            unroll_loops=True,
        )
        step, meta = build_cell(arch, shape.name, multi_pod=multi_pod,
                                overrides=ov, mesh=mesh, shape=shape)
        try:
            results.append(trace(step))
        finally:
            uninstall()
        del step
    r1, r2 = results

    def extrap(a, b):
        return a + (reps - 1) * (b - a)

    # per-kind collective extrapolation
    kinds = set(r1["summary"]) | set(r2["summary"])
    summary = {}
    for kind in kinds:
        s1 = r1["summary"].get(kind, {"count": 0, "bytes": 0.0, "wire": 0.0})
        s2 = r2["summary"].get(kind, {"count": 0, "bytes": 0.0, "wire": 0.0})
        summary[kind] = {f: extrap(s1[f], s2[f])
                         for f in ("count", "bytes", "wire")}

    out = {f: extrap(r1[f], r2[f])
           for f in ("flops", "bf16_flops", "bytes", "wire", "nvlink_wire")}
    out.update(
        summary=summary,
        memory={f: extrap(r1["memory"][f], r2["memory"][f])
                for f in r1["memory"]},
        meta=meta, reps=reps, probe_compile_s=round(time.time() - t0, 2),
        trace_s=round(r1["trace_s"] + r2["trace_s"], 2))
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None, out_dir: Path = ARTIFACTS,
             tag: str = "", mesh=None,
             shape: ShapeConfig | None = None) -> dict:
    """Trace one cell on the production grid of the current fake group
    (or on ``mesh``; ``shape`` replaces ``SHAPES[shape_name]``), write its
    artifact and return it."""
    shape = SHAPES[shape_name] if shape is None else shape
    skip = cell_is_skipped(arch, shape.name)
    cell_id = f"{arch}__{shape.name}__{'multi' if multi_pod else 'single'}"
    if tag:
        cell_id += f"__{tag}"
    if skip:
        art = {"cell": cell_id, "skipped": skip}
        _write(out_dir, cell_id, art)
        print(f"[dryrun] {cell_id}: SKIP ({skip})")
        return art

    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
    t_mesh = time.time() - t0
    cfg = _configured(arch, overrides)[0]
    probe = _probe_costs(arch, shape, multi_pod=multi_pod,
                         overrides=overrides, cfg=cfg, mesh=mesh)
    meta = probe["meta"]
    rl = _roofline(probe, meta["n_chips"], RL.model_flops_estimate(cfg, shape))
    art = {
        "cell": cell_id, **meta,
        "lower_s": round(t_mesh + probe["probe_compile_s"] - probe["trace_s"],
                         2),
        "compile_s": probe["trace_s"],
        "memory": _memory(probe["memory"]),
        "roofline": rl.to_json(),
        "split": _split(probe),
        "probe": {k: probe[k] for k in ("reps", "probe_compile_s")},
        "overrides": overrides or {},
    }
    _write(out_dir, cell_id, art)
    print(f"[dryrun] {cell_id}: ok  trace={probe['trace_s']:.1f}s  "
          f"dominant={rl.dominant}  bound={rl.bound_s*1e3:.2f}ms  "
          f"peak={art['memory']['peak_estimate_gib']}GiB")
    return art


# ---------------------------------------------------------------------------
# the CP-ALS workloads
# ---------------------------------------------------------------------------

def plan_cpals_workload(workload: str, *, policy: str = "auto",
                        nnz_cap: int = 200_000, cache: str | None = None,
                        method: str = "cp_als"):
    """Plan a paper decomposition workload from a scaled synthetic replica.

    The dry-run never materializes the full tensor; per-mode statistics are
    shape/skew properties, so a scaled-density replica (capped at ``nnz_cap``
    non-zeros) is enough evidence for the planner's regime rules.  The
    replica goes through ``repro_torch.ingest`` so stats are measured once
    (and, with ``cache=``, persist across dry-run invocations).  It lives
    on the CPU: the dry-run uses no card.

    ``method`` selects the registry entry whose kernel family is planned:
    the CP methods score the mttkrp registry at the workload's rank, Tucker
    scores the ttmc registry at each mode's Kronecker width (the
    kernel/width resolution lives in ``Session.plan`` — one place)."""
    from repro_torch.api import (DataConfig, MethodConfig, PlanConfig,
                                 RunConfig, Session)

    dims, nnz, rank = configs.CPALS_WORKLOADS[workload]
    scale = min(1.0, nnz_cap / nnz)
    cfg = RunConfig(
        data=DataConfig(dataset=configs.CPALS_DATASET[workload], scale=scale,
                        cache=cache),
        plan=PlanConfig(policy=policy),
        method=MethodConfig(name=method, rank=rank))
    return Session.from_config(cfg, device="cpu").plan()


def trace_cpals(workload: str, mesh, *, shard_c: bool = False,
                mode_order: str = "natural",
                local_impls: tuple[str, str, str] = ("scatter",) * 3):
    """Trace one distributed iteration of ``workload`` on ``mesh``:
    (roofline, memory, info, trace seconds)."""
    from repro_torch.core.distributed import build_dist_cpals_lowered

    iteration, info = build_dist_cpals_lowered(
        workload, mesh, shard_c=shard_c, mode_order=mode_order,
        local_impls=local_impls)
    counts = trace(Step(iteration.func, iteration.args))
    rl = _roofline(counts, mesh.axis_size(mesh.axis_names),
                   info["model_flops"])
    return rl, counts, info


def run_cpals(workload: str, *, multi_pod: bool, out_dir: Path = ARTIFACTS,
              shard_c: bool = False, mode_order: str = "natural",
              impl: str = "auto", tag: str = "",
              method: str = "cp_als", mesh=None) -> dict:
    """Dry-run the paper's own CP-ALS workload (distributed, medium-grained).

    The per-mode plan is derived from a scaled synthetic replica and threads
    into the traced iteration (each mode's local MTTKRP strategy).  The
    traced iteration is the ``dist`` executor's body, so ``method`` must be
    distributed-capable (``MethodSpec.supports_dist``) — others are rejected
    up front with the capability listing, same as ``dist_cp_als``.
    ``mesh``: the grid (the production grid of the current fake group by
    default)."""
    from repro_torch.api import require_capability
    from repro_torch.core.distributed import _local_impls_of
    from repro_torch.utils.report import plan_report

    # the one capability gate (repro_torch.api.executor) — same error text
    # as Session.fit(executor="dist") and dist_cp_als
    require_capability(method, "dist")
    plan = plan_cpals_workload(workload, policy=impl, method=method)
    print(plan_report(plan, method=method))
    local_impls = _local_impls_of(plan)
    if mode_order == "auto":
        # the iteration sorts modes longest-first; realign the per-mode impls
        dims = configs.CPALS_WORKLOADS[workload][0]
        perm = sorted(range(3), key=lambda m: -dims[m])
        local_impls = tuple(local_impls[m] for m in perm)
    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
    t_mesh = time.time() - t0
    rl, counts, info = trace_cpals(workload, mesh, shard_c=shard_c,
                                   mode_order=mode_order,
                                   local_impls=local_impls)
    info["plan"] = {f"mode{p.mode}": p.impl for p in plan.modes}
    info["method"] = method
    cell_id = f"{workload}__iteration__{'multi' if multi_pod else 'single'}"
    if tag:
        cell_id += f"__{tag}"
    art = {
        "cell": cell_id, "arch": workload, "shape": "iteration",
        "mesh": mesh.shape, "n_chips": mesh.axis_size(mesh.axis_names),
        "lower_s": round(time.time() - t0 - counts["trace_s"], 2),
        "compile_s": round(counts["trace_s"], 2),
        "memory": _memory(counts["memory"]),
        "roofline": rl.to_json(), "split": _split(counts),
        "info": {k: v for k, v in info.items() if k != "model_flops"},
    }
    _write(out_dir, cell_id, art)
    print(f"[dryrun] {cell_id}: ok  grid={t_mesh:.1f}s  "
          f"trace={counts['trace_s']:.1f}s  dominant={rl.dominant}  "
          f"bound={rl.bound_s*1e3:.2f}ms")
    return art


def _write(out_dir: Path, cell_id: str, art: dict) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_id}.json").write_text(json.dumps(art, indent=1))


# ---------------------------------------------------------------------------
# the matrix, one subprocess a cell
# ---------------------------------------------------------------------------

def run_all(out_dir: Path, *, resume: bool = True, jobs: int = 1) -> None:
    """Full matrix via one subprocess per cell (a fresh fake group of the
    cell's world size, resumable)."""
    cells = []
    for arch in configs.ARCH_NAMES:
        for shape in SHAPES:
            for mp in (False, True):
                cells.append((arch, shape, mp))
    for wl in configs.CPALS_WORKLOADS:
        for mp in (False, True):
            cells.append((wl, "cpals", mp))

    todo = []
    for arch, shape, mp in cells:
        suffix = "multi" if mp else "single"
        name = (f"{arch}__{shape}__{suffix}" if shape != "cpals"
                else f"{arch}__iteration__{suffix}")
        if resume and (out_dir / f"{name}.json").exists():
            continue
        todo.append((arch, shape, mp))
    print(f"[dryrun] {len(todo)} cells to run ({len(cells) - len(todo)} cached)")

    procs: list[tuple[subprocess.Popen, str]] = []
    for arch, shape, mp in todo:
        args = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch]
        if shape != "cpals":
            args += ["--shape", shape]
        args += ["--mesh", "multi" if mp else "single", "--out", str(out_dir)]
        while len(procs) >= jobs:
            procs = _reap(procs)
            time.sleep(0.5)
        p = subprocess.Popen(args, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((p, f"{arch}/{shape}/{mp}"))
    while procs:
        procs = _reap(procs)
        time.sleep(0.5)


def _reap(procs):
    alive = []
    for p, name in procs:
        if p.poll() is None:
            alive.append((p, name))
        else:
            out = p.stdout.read() if p.stdout else ""
            status = "ok" if p.returncode == 0 else f"FAIL rc={p.returncode}"
            print(f"[dryrun/all] {name}: {status}")
            if p.returncode != 0:
                print(out[-3000:])
    return alive


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="arch id or cpals-<workload>")
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", type=Path, default=ARTIFACTS)
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (perf pass)")
    args = ap.parse_args(argv)

    if args.all:
        run_all(args.out, jobs=args.jobs)
        return

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = json.loads(v)

    import resource

    resource.setrlimit(resource.RLIMIT_AS, (HOST_BYTES, HOST_BYTES))
    mp = args.mesh == "multi"
    init_fake_group(512 if mp else 256)
    if args.arch.startswith("cpals-"):
        run_cpals(args.arch, multi_pod=mp, out_dir=args.out,
                  shard_c=bool(overrides.get("shard_c")),
                  mode_order=overrides.get("mode_order", "natural"),
                  impl=overrides.get("impl", "auto"),
                  method=overrides.get("method", "cp_als"),
                  tag=args.tag)
    else:
        run_cell(args.arch, args.shape, multi_pod=mp,
                 overrides=overrides or None, out_dir=args.out, tag=args.tag)


if __name__ == "__main__":
    main()
