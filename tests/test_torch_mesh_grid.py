"""The production mesh's path on a 4-rank grid: parameters, optimizer state,
caches and activations as DTensors on gloo, against the same computation
unsharded on the same rank and against the JAX package.

One spawn for the whole file (``test_torch_distributed._spawn``: gloo over
a ``FileStore`` in ``tmp_path``, joined within 240 s) runs two grids one
after the other:

* ``(data=2, model=2)`` with ``rules_for(cfg)``: ``smoke_of(llama3.2-3b)``
  (4 heads, 2 KV heads, both split over 'model') placed by
  ``place_model``: ``loss`` and every gradient in float32, one AdamW step
  on placed state, then prefill and two decode steps on a cache placed by
  its axes; ``_flash_attention`` called directly (``qb = kb = 16`` at s =
  48) with the hook on and off, and on 3-head inputs with
  ``rules:flash_q`` (the q blocks split over 'model'); a 3-head llama's
  loss and gradients through that path (its threshold lowered to 1024
  positions in the ranks); ``chunked_loss``'s loss and gradients (the
  vocab-parallel cross-entropy); ``smoke_of(kimi-k2-1t-a32b)`` (FSDP, one
  shared expert) at capacity factor 8.0: ``moe_ffn_ep`` forward and
  gradients; a checkpoint of the placed parameters; ``Model.abstract``
  with a sharding function;
* ``(pod=2, data=1, model=2)`` with ``rules_for(cfg, multi_pod=True)``:
  the llama loss and gradients again.

Every rank writes what it computed (whole tensors, gathered on the rank);
the checks run here, where the reference values are computed with JAX
from the same numpy inputs.  Limits: sharded against unsharded, loss 1e-5,
gradients, parameters after the step and logits 1e-4; against the
reference's ``Model.loss`` and ``jax.value_and_grad``, loss 1e-5,
gradients 1e-4; the expert-parallel MoE against the reference's
``_moe_ffn_dense_dispatch`` (nothing dropped), output 1e-4 and gradients
1e-2 (the limits of the reference's own, red, EP test).  This module
imports neither JAX nor ``repro`` at import: the spawned ranks import it.
"""
import os

import numpy as np
import pytest
import torch

ARCH = "llama3.2-3b"
MOE_ARCH = "kimi-k2-1t-a32b"
BATCH, SEQ, DECODE = 4, 16, 2
FLASH = dict(b=2, s=48, blk=16)
FLASH_CASES = [("causal", False), ("causal", True), ("local", True)]
# rules:flash_q: 3 heads (1 KV head), which the model axis does not divide,
# and 4 q blocks, which it does: each model rank runs its 2 q blocks
FLASH_Q = dict(b=2, s=64, h=3, kv=1)
FLASH_Q_CASES = [("causal", False), ("local", True)]
# the model through the flash path with rules:flash_q: 3 heads, 1 KV head,
# the sequence at the shortest the path takes once its threshold is
# lowered (qb = 128: 8 q blocks, 1 KV block)
FQ_SEQ, FQ_MIN_SEQ = 1024, 1024
CHUNK = 8  # chunked_loss: two chunks of the 16 positions
FLASH_WINDOW = 20
MOE_CF = 8.0
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

def _np(x):
    """A copy of a tensor (a DTensor gathered whole) as numpy: a later
    in-place step cannot reach it."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy().copy()


def _model(cfg, params):
    from repro_torch import convert
    from repro_torch.models import Model

    m = Model(cfg)
    m.load_state_dict(convert.lm_params_from_numpy(cfg, params, "cpu"),
                      assign=True)
    return m


def _loss_and_grads(model, batch):
    loss, _ = model.loss(batch)
    loss.backward()
    grads = {k: _np(p.grad) for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(_np(loss)), grads


def _llama(model, batch, sfn):
    """Loss and gradients, one AdamW step (two micro-batches: the float32
    accumulator), one Adafactor step, then prefill and DECODE decode steps
    from the stepped parameters; ``sfn`` places the optimizer state (None:
    unsharded)."""
    from repro_torch import optim
    from repro_torch.launch import mesh as M
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import axes_tree

    out = {}
    out["loss"], out["grads"] = _loss_and_grads(model, batch)
    for name, micro in (("adamw", 2), ("adafactor", 1)):
        opt = optim.OPTIMIZERS[name]()
        state = opt.init(model.params())
        if sfn is not None:
            state = M.place(state, opt.state_axes(axes_tree(
                model.param_specs())), sfn)
        state, met = make_train_step(model, opt, micro_batches=micro)(
            state, batch, 0)
        out[f"{name}_loss"] = float(_np(met["loss"]))
        out[f"{name}_params"] = {k: _np(v)
                                 for k, v in model.state_dict().items()}
        out[f"{name}_state"] = {k: _np(v) for k, v in _flat(state).items()}
    cache = model.init_cache(BATCH, SEQ + DECODE)
    logits, _ = model.prefill({"tokens": batch["tokens"]}, cache)
    steps = [_np(logits)]
    for i in range(DECODE):
        logits, _ = model.decode_step(batch["tokens"][:, i:i + 1], cache,
                                      SEQ + i)
        steps.append(_np(logits))
    out["logits"] = np.concatenate(steps, axis=1)
    out["cache"] = cache
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flash(cfg, mesh, rules, inp):
    """``_flash_attention`` on the same q, k, v with the hook off and on:
    outputs and the gradients of ``sum(out * w)``."""
    import dataclasses

    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(cfg, window=FLASH_WINDOW)
    out = {}
    for kind, skip in FLASH_CASES:
        for hook in (False, True):
            if hook:
                M.install(mesh, rules)
            try:
                q, k, v = (torch.from_numpy(inp[n]).requires_grad_()
                           for n in ("q", "k", "v"))
                o = L._flash_attention(cfg, q, k, v, kind, qb=FLASH["blk"],
                                       kb=FLASH["blk"], block_skip=skip)
                w = L.replicated_like(torch.from_numpy(inp["w"]), o)
                (o * w).sum().backward()
                out[(kind, skip, hook)] = {
                    "out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                    "dv": _np(v.grad),
                    "dtensor": type(o).__name__ == "DTensor"}
            finally:
                M.uninstall()
    return out


def _flash_q(cfg, mesh, inp):
    """``_flash_attention`` with ``rules_for(cfg, flash_q="model")``, hook
    off and on, on 3-head inputs: the on side splits its q blocks over
    'model' and runs each rank's against the whole K/V."""
    import dataclasses

    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(cfg, window=FLASH_WINDOW)
    rules = M.rules_for(cfg, overrides={"flash_q": "model"})
    out = {}
    for kind, skip in FLASH_Q_CASES:
        for hook in (False, True):
            if hook:
                M.install(mesh, rules)
            try:
                q, k, v = (torch.from_numpy(inp[f"fq_{n}"]).requires_grad_()
                           for n in ("q", "k", "v"))
                o = L._flash_attention(cfg, q, k, v, kind, qb=FLASH["blk"],
                                       kb=FLASH["blk"], block_skip=skip)
                w = L.replicated_like(torch.from_numpy(inp["fq_w"]), o)
                (o * w).sum().backward()
                out[(kind, skip, hook)] = {
                    "out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                    "dv": _np(v.grad),
                    "placements": (tuple(o.placements) if hook else None)}
            finally:
                M.uninstall()
    return out


def _flash_q_model(inp, mesh):
    """A 3-head llama through ``Model.loss`` at FQ_SEQ positions, the flash
    path's threshold lowered to reach it: unsharded, then placed with
    ``rules:flash_q`` (``attention`` hands the core its q blocks split, the
    q-parallel path's calls counted): loss and gradients."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(configs.smoke_of(configs.get(ARCH)),
                              num_heads=3, num_kv_heads=1)
    batch = {"tokens": torch.from_numpy(inp["fq_tokens"]),
             "labels": torch.from_numpy(inp["fq_labels"])}
    rules = M.rules_for(cfg, overrides={"flash_q": "model"})
    calls = []
    saved = L.FLASH_MIN_SEQ, L._q_parallel

    def counted(*a, **k):
        calls.append(1)
        return saved[1](*a, **k)

    L.FLASH_MIN_SEQ, L._q_parallel = FQ_MIN_SEQ, counted
    try:
        out = {"plain": _loss_and_grads(_model(cfg, inp["fq_params"]),
                                        batch)}
        out["plain_calls"] = len(calls)
        model = M.place_model(_model(cfg, inp["fq_params"]),
                              M.sharding_fn(mesh, rules))
        M.install(mesh, rules)
        try:
            out["mesh"] = _loss_and_grads(model, batch)
        finally:
            M.uninstall()
        out["mesh_calls"] = len(calls) - out["plain_calls"]
    finally:
        L.FLASH_MIN_SEQ, L._q_parallel = saved
    return out


def _chunked(cfg, mesh, inp):
    """``Model.loss`` with ``chunked_loss``: the vocab-parallel
    cross-entropy a chunk at a time, unsharded and placed."""
    import dataclasses

    from repro_torch.launch import mesh as M

    cfg = dataclasses.replace(cfg, chunked_loss=CHUNK)
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    rules = M.rules_for(cfg)
    out = {"plain": _loss_and_grads(_model(cfg, inp["params"]), batch)}
    model = M.place_model(_model(cfg, inp["params"]),
                          M.sharding_fn(mesh, rules))
    M.install(mesh, rules)
    try:
        out["mesh"] = _loss_and_grads(model, batch)
    finally:
        M.uninstall()
    return out


def _moe(mesh, rules_fn, inp):
    """``moe_ffn_ep`` on placed parameters and input against the dense
    dispatch unsharded: outputs and the gradients of ``sum(out ** 2)``;
    and which dispatch ``moe_ffn`` takes under the installed mesh."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import axes_tree

    cfg = configs.smoke_of(configs.get(MOE_ARCH))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CF))
    rules = rules_fn(cfg)
    sfn = M.sharding_fn(mesh, rules)
    specs = MOE.moe_specs(cfg)
    x = torch.from_numpy(inp["moe_x"])

    def params():
        return {k: torch.from_numpy(v).requires_grad_()
                for k, v in inp["moe_params"].items()}

    res = {"fsdp": cfg.fsdp}
    p = params()
    out, met = MOE._moe_ffn_dense_dispatch(p, cfg, x)
    (out ** 2).sum().backward()
    res["dense"] = {"out": _np(out), "drop": float(met["moe_drop_frac"]),
                    "grads": {k: _np(v.grad) for k, v in p.items()}}
    pp = M.place(params(), axes_tree(specs), sfn)
    xs = M.place({"x": x}, {"x": ("act_batch", None, None)}, sfn)["x"]
    out, met = MOE.moe_ffn_ep(pp, cfg, xs, mesh)
    (out ** 2).sum().backward()
    res["ep"] = {"out": _np(out), "drop": float(_np(met["moe_drop_frac"])),
                 "grads": {k: _np(v.grad) for k, v in pp.items()},
                 "placements": {k: tuple(v.placements)
                                for k, v in pp.items()},
                 "grad_placements": {k: tuple(v.grad.placements)
                                     for k, v in pp.items()}}
    M.install(mesh, rules)
    try:
        out, met = MOE.moe_ffn(pp, cfg, xs)
        res["moe_ffn"] = {"out": _np(out), "metrics": sorted(met)}
    finally:
        M.uninstall()
    return res


def _grids(rank, inp, ckpt_root):
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.collectives import make_mesh
    from repro_torch.launch import mesh as M
    from repro_torch.models import Model
    from repro_torch.models.params import axes_tree

    cfg = configs.smoke_of(configs.get(ARCH))
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    res = {}

    # grid A: (data=2, model=2)
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = M.rules_for(cfg)
    sfn = M.sharding_fn(mesh, rules)
    res["plain"] = _llama(_model(cfg, inp["params"]), batch, None)
    res["plain"].pop("cache")
    model = M.place_model(_model(cfg, inp["params"]), sfn)
    res["placed"] = {k: tuple(v.placements)
                     for k, v in model.state_dict().items()}
    axes = _flat(axes_tree(model.param_specs()))
    res["want_placed"] = {k: tuple(sfn(axes[k], tuple(v.shape)).placements)
                          for k, v in model.state_dict().items()}
    M.install(mesh, rules)
    try:
        res["mesh"] = _llama(model, batch, sfn)
    finally:
        M.uninstall()
    cache = res["mesh"].pop("cache")
    spec = _flat(model.cache_specs(BATCH, SEQ + DECODE))
    res["cache_placed"] = all(
        tuple(v.placements) == tuple(sfn(spec[k].axes, spec[k].shape)
                                     .placements)
        for k, v in _flat(cache).items())

    # int8 compression of placed gradients against the same values whole
    from repro_torch.dist.compress import compress_grads_int8

    whole_g = {k: torch.from_numpy(v) for k, v in res["mesh"]["grads"].items()}
    axes = _flat(axes_tree(model.param_specs()))
    placed_g = M.place(whole_g, axes, sfn)
    want_c = compress_grads_int8(whole_g)
    got_c = compress_grads_int8(placed_g)
    res["compress"] = [(_np(g[k]), w[k].numpy()) for g, w in
                       zip(got_c, want_c) for k in sorted(whole_g)]
    res["compress_placed"] = all(
        tuple(got_c[0][k].placements) == tuple(placed_g[k].placements)
        for k in placed_g)

    # a checkpoint of the placed parameters (each rank its own directory)
    tree = model.params()
    mgr = CheckpointManager(os.path.join(ckpt_root, f"rank{rank}"),
                            async_save=False)
    mgr.save(1, tree)
    restored, _ = mgr.restore(tree)
    whole = {k: _np(v) for k, v in _flat(tree).items()}
    back = {k: v.detach().numpy() for k, v in _flat(restored).items()}
    replaced = M.place(restored, axes_tree(model.param_specs()), sfn)
    res["ckpt"] = {"whole": whole, "restored": back,
                   "replaced": {k: _np(v) for k, v in
                                _flat(replaced).items()},
                   "plain_restored": all(
                       type(v) is torch.Tensor
                       for v in _flat(restored).values())}

    # Model.abstract with the sharding function: meta DTensors
    abstract = _flat(Model(cfg).abstract(sfn))
    res["abstract"] = {k: (v.device.type, tuple(v.shape),
                           tuple(v.to_local().shape), tuple(v.placements))
                       for k, v in abstract.items()}
    res["abstract_want"] = {
        k: tuple(sfn(a, s).placements) for k, (a, s) in
        ((k, (sp.axes, sp.shape)) for k, sp in
         _flat(Model(cfg).param_specs()).items())}

    res["flash"] = _flash(cfg, mesh, rules, inp)
    res["flash_q"] = _flash_q(cfg, mesh, inp)
    res["flash_q_model"] = _flash_q_model(inp, mesh)
    res["chunked"] = _chunked(cfg, mesh, inp)
    res["moe"] = _moe(mesh, lambda c: M.rules_for(c), inp)

    # grid B: (pod=2, data=1, model=2), the pod-aware rules
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    rules = M.rules_for(cfg, multi_pod=True)
    sfn = M.sharding_fn(mesh, rules)
    model = M.place_model(_model(cfg, inp["params"]), sfn)
    M.install(mesh, rules)
    try:
        res["pod"] = dict(zip(("loss", "grads"),
                              _loss_and_grads(model, batch)))
        res["pod"]["tokens_placements"] = tuple(M.place(
            {"t": batch["tokens"]}, {"t": ("act_batch", None)},
            sfn)["t"].placements)
    finally:
        M.uninstall()
    res["rss_kb"] = _peak_rss_kb()
    if rank:  # every rank gathered the same whole tensors: rank 0's go up
        return {"losses": (res["mesh"]["loss"], res["pod"]["loss"],
                           res["mesh"]["adamw_loss"]),
                "logits": res["mesh"]["logits"], "rss_kb": res["rss_kb"]}
    return res


def _peak_rss_kb() -> int:
    """This process's peak resident set (``VmHWM``): ``getrusage``'s
    ``ru_maxrss`` keeps the parent's peak across the spawn's exec."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1])
    raise RuntimeError("no VmHWM in /proc/self/status")


# ---------------------------------------------------------------------------
# the spawn and the reference, once for the file
# ---------------------------------------------------------------------------

def _inputs():
    """Every input, drawn with numpy from seeds."""
    import dataclasses

    from test_torch_helpers import np_params

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models import moe as MOE

    cfg = configs.smoke_of(configs.get(ARCH))
    rng = np.random.default_rng(7)
    labels = rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32)
    labels[0, :3] = -1
    f = FLASH
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mcfg = configs.smoke_of(configs.get(MOE_ARCH))
    fq = FLASH_Q
    fq_cfg = dataclasses.replace(cfg, num_heads=3, num_kv_heads=1)
    fq_labels = rng.integers(0, cfg.vocab, (fq["b"], FQ_SEQ), dtype=np.int32)
    fq_labels[1, :5] = -1
    return {
        "fq_q": rng.standard_normal((fq["b"], fq["s"], fq["h"], hd),
                                    np.float32),
        "fq_k": rng.standard_normal((fq["b"], fq["s"], fq["kv"], hd),
                                    np.float32),
        "fq_v": rng.standard_normal((fq["b"], fq["s"], fq["kv"], hd),
                                    np.float32),
        "fq_w": rng.standard_normal((fq["b"], fq["s"], fq["h"], hd),
                                    np.float32),
        "fq_params": np_params(Model(fq_cfg).param_specs(), 5),
        "fq_tokens": rng.integers(0, cfg.vocab, (fq["b"], FQ_SEQ),
                                  dtype=np.int32),
        "fq_labels": fq_labels,
        "params": np_params(Model(cfg).param_specs(), 0),
        "tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32),
        "labels": labels,
        "q": rng.standard_normal((f["b"], f["s"], h, hd), np.float32),
        "k": rng.standard_normal((f["b"], f["s"], kv, hd), np.float32),
        "v": rng.standard_normal((f["b"], f["s"], kv, hd), np.float32),
        "w": rng.standard_normal((f["b"], f["s"], h, hd), np.float32),
        "moe_params": np_params(MOE.moe_specs(mcfg), 3),
        "moe_x": (0.5 * rng.standard_normal((BATCH, SEQ, mcfg.d_model))
                  ).astype(np.float32),
    }


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    from test_torch_distributed import _spawn

    tmp = tmp_path_factory.mktemp("mesh_grid")
    inp = _inputs()
    return inp, _spawn(tmp, 4, _grids, inp, str(tmp / "ckpt"))


@pytest.fixture(scope="module")
def reference(grid):
    """The JAX package's loss and gradients on the same inputs, and its
    dense MoE dispatch's output and gradients."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.models import Model as JaxModel
    from repro.models import moe as JMOE
    from test_torch_helpers import lm_cfgs

    inp, _ = grid
    jcfg, _ = lm_cfgs(ARCH)
    jm = JaxModel(jcfg)
    params = jax.tree.map(jnp.asarray, inp["params"])
    batch = {"tokens": jnp.asarray(inp["tokens"]),
             "labels": jnp.asarray(inp["labels"])}
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    mcfg, _ = lm_cfgs(MOE_ARCH)
    mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(
        mcfg.moe, capacity_factor=MOE_CF))
    mp = jax.tree.map(jnp.asarray, inp["moe_params"])
    x = jnp.asarray(inp["moe_x"])

    def moe_loss(p):
        out, _ = JMOE._moe_ffn_dense_dispatch(p, mcfg, x)
        return jnp.sum(out ** 2), out

    (_, mout), mgrads = jax.jit(jax.value_and_grad(moe_loss,
                                                   has_aux=True))(mp)
    return {"loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in _flat(grads).items()},
            "moe_out": np.asarray(mout),
            "moe_grads": {k: np.asarray(v) for k, v in mgrads.items()}}


def _close_trees(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# grid A: (data=2, model=2)
# ---------------------------------------------------------------------------

def test_parameters_are_placed_by_their_axes(grid):
    _, (r0, *_) = grid
    assert r0["placed"] == r0["want_placed"]
    from torch.distributed.tensor import Shard

    assert Shard(2) in r0["placed"]["stack.b0.attn.wq"]  # heads on model


def test_loss_and_grads_sharded_equal_unsharded(grid):
    _, (r0, *_) = grid
    np.testing.assert_allclose(r0["mesh"]["loss"], r0["plain"]["loss"],
                               **LOSS_TOL)
    _close_trees(r0["mesh"]["grads"], r0["plain"]["grads"], **TOL)


def test_loss_and_grads_sharded_match_reference(grid, reference):
    _, (r0, *_) = grid
    np.testing.assert_allclose(r0["mesh"]["loss"], reference["loss"],
                               **LOSS_TOL)
    _close_trees(r0["mesh"]["grads"], reference["grads"], **GRAD_TOL)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_step_sharded_equals_unsharded(grid, opt):
    """One step on placed state (AdamW over two micro-batches, through the
    float32 accumulator; Adafactor's factored statistics placed by their
    own axes): its loss, the parameters after it and the state."""
    _, (r0, *_) = grid
    np.testing.assert_allclose(r0["mesh"][f"{opt}_loss"],
                               r0["plain"][f"{opt}_loss"], **LOSS_TOL)
    _close_trees(r0["mesh"][f"{opt}_params"], r0["plain"][f"{opt}_params"],
                 **TOL)
    _close_trees(r0["mesh"][f"{opt}_state"], r0["plain"][f"{opt}_state"],
                 **TOL)


def test_int8_compression_of_placed_gradients(grid):
    """``compress_grads_int8`` on DTensor gradients against the same values
    whole: the int8 payload, the scales and the residuals bit for bit, the
    payload placed as its gradient."""
    _, (r0, *_) = grid
    assert r0["compress_placed"]
    for got, want in r0["compress"]:
        np.testing.assert_array_equal(got, want)


def test_prefill_and_decode_sharded_equal_unsharded(grid):
    """Prefill and two decode steps on a cache placed by its axes
    (``cache_batch`` on data, ``kv_heads`` on model)."""
    _, (r0, *_) = grid
    assert r0["cache_placed"]
    np.testing.assert_allclose(r0["mesh"]["logits"], r0["plain"]["logits"],
                               **TOL)


@pytest.mark.parametrize("kind,skip,rule", [
    *(pytest.param(k, s, None, id=f"{k}-{s}") for k, s in FLASH_CASES),
    *(pytest.param(k, s, "flash_q", id=f"flash_q-{k}-{s}")
      for k, s in FLASH_Q_CASES)])
def test_flash_attention_with_the_hook_equals_without(grid, kind, skip,
                                                      rule):
    """``_flash_attention`` called directly with small blocks: the hook
    on (q blocks, repeated KV blocks and the output constrained, so the
    loop runs on DTensors) against off, output and gradients 1e-4; off
    against the reference's.  The ``flash_q`` cases: 3 heads, which the
    model axis does not divide, and ``rules:flash_q``: each model rank
    runs its own q blocks against the whole K/V (the K/V gradients partial
    sums), the output placed as the reference's constraint names it (q
    blocks on 'model')."""
    import dataclasses

    import jax.numpy as jnp

    from repro.models import layers as JL
    from test_torch_helpers import lm_cfgs

    inp, (r0, *_) = grid
    if rule is None:
        on = r0["flash"][(kind, skip, True)]
        off = r0["flash"][(kind, skip, False)]
        assert on["dtensor"] and not off["dtensor"]
        names = ("q", "k", "v")
    else:
        from torch.distributed.tensor import Shard

        on = r0["flash_q"][(kind, skip, True)]
        off = r0["flash_q"][(kind, skip, False)]
        # batch on 'data', the sequence (the q blocks) on 'model'
        assert on["placements"] == (Shard(0), Shard(1))
        names = ("fq_q", "fq_k", "fq_v")
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(on[key], off[key], err_msg=key, **TOL)
    jcfg, _ = lm_cfgs(ARCH)
    jcfg = dataclasses.replace(jcfg, window=FLASH_WINDOW)
    want = JL._flash_attention(jcfg, *(jnp.asarray(inp[n])
                                       for n in names), kind,
                               qb=FLASH["blk"], kb=FLASH["blk"],
                               block_skip=skip)
    np.testing.assert_allclose(off["out"], np.asarray(want), **TOL)


def test_flash_q_model_loss_and_grads_sharded_equal_unsharded(grid):
    """A 3-head llama through ``Model.loss`` on the flash path with
    ``rules:flash_q``: ``attention`` hands the core its q blocks split,
    and the loss and every gradient (the K/V projections' from partial
    sums) equal the unsharded model's."""
    _, (r0, *_) = grid
    fq = r0["flash_q_model"]
    assert fq["plain_calls"] == 0 and fq["mesh_calls"] >= 2  # each layer
    np.testing.assert_allclose(fq["mesh"][0], fq["plain"][0], **LOSS_TOL)
    _close_trees(fq["mesh"][1], fq["plain"][1], **TOL)


def test_chunked_loss_and_grads_sharded_equal_unsharded(grid):
    """``chunked_loss``: the vocab-parallel cross-entropy (each rank's
    logsumexp and gold logit over its vocab block, a chunk at a time)
    against the unsharded loss and gradients, and against the whole-logit
    loss."""
    _, (r0, *_) = grid
    ch = r0["chunked"]
    np.testing.assert_allclose(ch["mesh"][0], ch["plain"][0], **LOSS_TOL)
    _close_trees(ch["mesh"][1], ch["plain"][1], **TOL)
    np.testing.assert_allclose(ch["plain"][0], r0["plain"]["loss"],
                               **LOSS_TOL)


def test_ep_moe_matches_the_dense_dispatch(grid, reference):
    """``moe_ffn_ep`` (FSDP weights, one shared expert, capacity factor 8:
    nothing dropped) against the port's dense dispatch unsharded and the
    reference's: output 1e-4, gradients of wg, wd, router, shared_wg
    1e-2, every gradient leaf placed as its parameter."""
    _, (r0, *_) = grid
    moe = r0["moe"]
    assert moe["fsdp"]
    ep, dense = moe["ep"], moe["dense"]
    assert ep["drop"] == 0.0 and dense["drop"] == 0.0
    np.testing.assert_allclose(ep["out"], dense["out"], **TOL)
    np.testing.assert_allclose(ep["out"], reference["moe_out"], **TOL)
    for k in ("wg", "wd", "router", "shared_wg"):
        for want in (dense["grads"][k], reference["moe_grads"][k]):
            np.testing.assert_allclose(ep["grads"][k], want, rtol=1e-2,
                                       atol=1e-2, err_msg=k)
    from torch.distributed.tensor import Shard

    assert ep["placements"]["wg"] == (Shard(1), Shard(0))  # FSDP x experts


def test_moe_ffn_takes_the_expert_parallel_dispatch_under_the_mesh(grid):
    _, (r0, *_) = grid
    moe = r0["moe"]
    assert moe["moe_ffn"]["metrics"] == ["moe_drop_frac"]
    np.testing.assert_array_equal(moe["moe_ffn"]["out"], moe["ep"]["out"])


def test_checkpoint_of_a_sharded_tree_restores_bit_for_bit(grid):
    """Saved from DTensors (each leaf gathered whole), restored as plain
    tensors that ``place`` distributes again: bit for bit."""
    _, (r0, *_) = grid
    ck = r0["ckpt"]
    assert ck["plain_restored"]
    for k, v in ck["whole"].items():
        np.testing.assert_array_equal(ck["restored"][k], v, err_msg=k)
        np.testing.assert_array_equal(ck["replaced"][k], v, err_msg=k)


def test_abstract_params_with_a_sharding_function(grid):
    """``Model.abstract(sharding_fn)``: meta DTensors, the global shape,
    each placed as the sharding function says (its local shard's shape
    split over the grid)."""
    _, (r0, *_) = grid
    assert set(r0["abstract"]) == set(r0["abstract_want"])
    from torch.distributed.tensor import Shard

    for k, (dev, shape, local, pl) in r0["abstract"].items():
        assert dev == "meta" and pl == r0["abstract_want"][k], k
        want = list(shape)
        for p in pl:
            if isinstance(p, Shard):
                want[p.dim] //= 2
        assert list(local) == want, k


# ---------------------------------------------------------------------------
# grid B: (pod=2, data=1, model=2), and every rank
# ---------------------------------------------------------------------------

def test_pod_grid_loss_and_grads(grid, reference):
    """The batch over ``("pod", "data")``, pod-major: sharded against
    unsharded and against the reference."""
    from torch.distributed.tensor import Replicate, Shard

    _, (r0, *_) = grid
    assert r0["pod"]["tokens_placements"] == (Shard(0), Shard(0),
                                              Replicate())
    np.testing.assert_allclose(r0["pod"]["loss"], r0["plain"]["loss"],
                               **LOSS_TOL)
    _close_trees(r0["pod"]["grads"], r0["plain"]["grads"], **TOL)
    np.testing.assert_allclose(r0["pod"]["loss"], reference["loss"],
                               **LOSS_TOL)
    _close_trees(r0["pod"]["grads"], reference["grads"], **GRAD_TOL)


def test_every_rank_gathers_the_same(grid):
    """... and each rank stayed under 1.5 GB of peak RSS."""
    _, (r0, *rest) = grid
    print("peak RSS a rank, MB:", [r["rss_kb"] / 1024 for r in grid[1]])
    assert all(r["rss_kb"] < 1.5 * 1024 * 1024 for r in grid[1])
    for r in rest:
        assert r["losses"] == (r0["mesh"]["loss"], r0["pod"]["loss"],
                               r0["mesh"]["adamw_loss"])
        np.testing.assert_array_equal(r["logits"], r0["mesh"]["logits"])
