"""Every other block kind and input through the production mesh on a 4-rank
grid: RWKV-6, RG-LRU with its local ring, the encoder-decoder with its
cross cache, embedding inputs with M-RoPE, GeGLU with a scaled embedding,
and MoE (the expert-parallel dispatch at prefill, the dense one a decode
step's single position falls back to), each served with its parameters
placed on a ``(data=2, model=2)`` grid, against the same model unsharded
on the same rank.

One spawn for the whole file (``test_torch_distributed._spawn``: gloo over
a ``FileStore`` in ``tmp_path``, joined within 240 s).  Each rank serves
every preset's ``smoke_of`` model twice through ``serve_batch`` and
``generate`` (batch 4, prompt 16, 3 tokens), without and with the hook:
the logits within 1e-4 and the same greedy tokens.  The inputs and parameters are drawn with torch from
seeds on each rank alike.  The kinds whose mesh path runs per-rank blocks
or gathers (RWKV-6's recurrence and group norm, RG-LRU, M-RoPE and the
embedding inputs, the encoder's source, the MoE's layout with and without
shared experts, at a capacity factor where no token drops) also take one
loss and its gradients each way, on a ``TokenPipeline`` batch (4 x 32):
the loss and every gradient within 1e-4.  This module imports neither JAX nor ``repro``.
"""
import dataclasses

import numpy as np
import pytest
import torch

ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "seamless-m4t-large-v2",
         "qwen2-vl-7b", "gemma-7b", "dbrx-132b")
BATCH, PROMPT, GEN = 4, 16, 3
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "qwen2-vl-7b",
               "seamless-m4t-large-v2", "dbrx-132b", "kimi-k2-1t-a32b")
TRAIN_SEQ = 32
NO_DROP_CF = 8.0


def _train_all(mesh):
    """Each of ``TRAIN_ARCHS``' loss and gradients without and with the
    hook, from the same parameters and batch."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh as M
    from repro_torch.models import Model

    def whole(t):
        if t is None:  # a parameter the loss does not reach
            return None
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy().copy()

    out = {}
    for arch in TRAIN_ARCHS:
        cfg = configs.smoke_of(configs.get(arch))
        if cfg.moe is not None:
            # the two dispatches size their buffers apart, so they drop
            # other tokens: compare where none drops
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=NO_DROP_CF))
        rules = M.rules_for(cfg)
        batch = TokenPipeline(cfg, BATCH, TRAIN_SEQ, seed=2,
                              device="cpu").batch_at(0)
        res = {}
        for hook in (False, True):
            model = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
            if hook:
                M.place_model(model, M.sharding_fn(mesh, rules))
                M.install(mesh, rules)
            try:
                loss, _ = model.loss(batch)
                loss.backward()
            finally:
                M.uninstall()
            res[hook] = {"loss": float(whole(loss)),
                         "grads": {n: whole(q.grad)
                                   for n, q in model.named_parameters()}}
        out[arch] = res
    return out


def _serve_all(rank):
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.dist.collectives import make_mesh
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import generate, serve_batch
    from repro_torch.models import Model

    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = configs.smoke_of(configs.get(arch))
        rules = M.rules_for(cfg)
        res = {}
        for hook in (False, True):
            model = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
            rng = np.random.default_rng(1)
            prompts = rng.integers(0, cfg.vocab, (BATCH, PROMPT),
                                   dtype=np.int32)
            batch = serve_batch(model, prompts, rng)
            if hook:
                M.place_model(model, M.sharding_fn(mesh, rules))
                M.install(mesh, rules)
            try:
                got = generate(model, batch, gen=GEN)
            finally:
                M.uninstall()
            logits = got["logits"]
            res[hook] = {"placed": isinstance(logits, DTensor),
                         "logits": (logits.full_tensor()
                                    if isinstance(logits, DTensor)
                                    else logits).numpy().copy(),
                         "tokens": got["tokens"]}
        out[arch] = res
    out["train"] = _train_all(mesh)
    return out if rank == 0 else {a: out[a][True]["tokens"] for a in ARCHS}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from test_torch_distributed import _spawn

    return _spawn(tmp_path_factory.mktemp("mesh_families"), 4, _serve_all)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_through_the_mesh_as_unsharded(served, arch):
    r0, *rest = served
    plain, meshed = r0[arch][False], r0[arch][True]
    assert meshed["placed"] and not plain["placed"]
    np.testing.assert_allclose(meshed["logits"], plain["logits"], **TOL)
    np.testing.assert_array_equal(meshed["tokens"], plain["tokens"])
    for r in rest:
        np.testing.assert_array_equal(r[arch], meshed["tokens"])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_trained_through_the_mesh_as_unsharded(served, arch):
    plain, meshed = (served[0]["train"][arch][h] for h in (False, True))
    np.testing.assert_allclose(meshed["loss"], plain["loss"], **TOL)
    assert meshed["grads"].keys() == plain["grads"].keys()
    for name, g in plain["grads"].items():
        if g is None:
            assert meshed["grads"][name] is None, (arch, name)
            continue
        np.testing.assert_allclose(meshed["grads"][name], g, **TOL,
                                   err_msg=f"{arch} {name}")
