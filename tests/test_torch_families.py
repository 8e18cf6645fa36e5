"""The six LM families beyond the dense one, as whole smoke models:
``repro_torch.models.Model`` against ``repro.models.Model``.

rwkv6-3b (the ``rwkv`` kind), recurrentgemma-9b (``rec`` x2 + local
``attn``, a ``(rec, rec)`` suffix), qwen2-vl-7b (``embeds`` inputs, M-RoPE),
seamless-m4t-large-v2 (the encoder-decoder), dbrx-132b and kimi-k2-1t-a32b
(``moe``; kimi with a dense prefix layer and a shared expert), each at
``smoke_of`` width with the same numpy-drawn parameters in both packages.
Forward, prefill and decode logits within 1e-4 (rtol and atol), every
cache leaf after every call too, the MoE metrics, the cache specs and
dtypes; and the port's own run of the reference's six
``test_decode_consistency_*`` cases (``tests/test_models.py``), at their
limits.  The reference side runs under ``jax.jit``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig, MoEConfig

from test_torch_helpers import lm_cfgs, lm_pair_np, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("rwkv6-3b", "recurrentgemma-9b", "qwen2-vl-7b",
            "seamless-m4t-large-v2", "dbrx-132b", "kimi-k2-1t-a32b")
B, S, STEPS, SRC = 2, 10, 3, 6   # prompt 10 > recurrentgemma's window 8


def close(got, want, **tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **(tol or TOL))


def tree_close(got, want, **tol):
    got, want = to_np(got), to_np(want)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            tree_close(got[k], want[k], **tol)
        else:
            assert got[k].shape == want[k].shape, k
            close(got[k], want[k], **tol)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def inputs(cfg, jp, seed=0):
    """Numpy inputs over S + STEPS positions, as the reference's serve
    builds them: token ids (or their embeddings through the table),
    M-RoPE positions on all three streams, source frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    full = {"tokens": tok}
    if cfg.input_mode == "embeds":
        full = {"embeds": np.array(JL.embed({"table": jp["embed"]["table"]},
                                             cfg, jnp.asarray(tok)))}
    if cfg.rope == "mrope":
        full["positions"] = np.broadcast_to(
            np.arange(S + STEPS, dtype=np.int32)[None, None],
            (3, B, S + STEPS)).copy()
    if cfg.encdec:
        full["src_embeds"] = rng.standard_normal(
            (B, SRC, cfg.d_model)).astype(np.float32)
    return tok, full


def snapshot(tree):
    """A copy of a cache tree as numpy (the port's is written in place)."""
    return {k: snapshot(v) if isinstance(v, dict) else to_np(v).copy()
            for k, v in tree.items()}


def prefix_of(batch, s):
    return {k: v if k == "src_embeds" else
            (v[..., :s] if k == "positions" else v[:, :s])
            for k, v in batch.items()}


def step_positions(cfg, pos):
    if cfg.rope != "mrope":
        return None
    return np.full((3, B, 1), pos, np.int32)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The pair of smoke models and the reference's outputs: the forward
    over S + STEPS positions, then a prefill of S and STEPS decode steps,
    with the cache after each call."""
    jm, jp, pm = lm_pair_np(request.param)
    cfg = jm.cfg
    tok, full = inputs(cfg, jp)
    jfull = jax.tree.map(jnp.asarray, full)
    fwd = jax.jit(functools.partial(jm.forward, mode="train"))
    logits, _, metrics = fwd(jp, jfull)
    ref = {"forward": np.asarray(logits),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    cache = jm.init_cache(B, S + STEPS + 1, src_len=SRC if cfg.encdec else 0)
    logits, cache = jax.jit(jm.prefill)(jp, prefix_of(jfull, S), cache)
    calls = [(np.asarray(logits), to_np(cache))]
    decode = jax.jit(jm.decode_step)
    for pos in range(S, S + STEPS):
        positions = step_positions(cfg, pos)
        logits, cache = decode(jp, jnp.asarray(tok[:, pos:pos + 1]), cache,
                               jnp.array(pos, jnp.int32),
                               positions=None if positions is None
                               else jnp.asarray(positions))
        calls.append((np.asarray(logits), to_np(cache)))
    ref["calls"] = calls
    return pm, tok, full, ref


def test_forward_matches_reference(family):
    pm, _, full, ref = family
    batch = {k: torch.as_tensor(v) for k, v in full.items()}
    with torch.no_grad():
        got, cache, metrics = pm(batch)
        hid, _, _ = pm(batch, mode="hidden")
    assert cache is None
    assert got.shape == (B, S + STEPS, pm.cfg.vocab)
    assert hid.shape == (B, S + STEPS, pm.cfg.d_model)
    close(got, ref["forward"])
    assert set(metrics) == set(ref["metrics"])
    assert bool(pm.cfg.moe) == bool(metrics)
    for key, want in ref["metrics"].items():
        assert abs(float(metrics[key]) - want) < 1e-5, key


def test_prefill_and_decode_match_reference(family):
    """The logits and every cache leaf after the prefill and after each
    decode step; the cache's tensors stay the same objects throughout (it
    is written in place); the last step against the port's forward at the
    reference's decode limits."""
    pm, tok, full, ref = family
    cfg = pm.cfg
    batch = {k: torch.as_tensor(v) for k, v in full.items()}
    cache = pm.init_cache(B, S + STEPS + 1, src_len=SRC if cfg.encdec else 0)
    held = dict(leaves(cache))
    logits, cache = pm.prefill(prefix_of(batch, S), cache)
    assert all(t is held[k] for k, t in leaves(cache))
    got = [(logits, snapshot(cache))]
    for pos in range(S, S + STEPS):
        positions = step_positions(cfg, pos)
        logits, cache = pm.decode_step(
            torch.as_tensor(tok[:, pos:pos + 1]), cache, pos,
            positions=None if positions is None
            else torch.as_tensor(positions))
        assert all(t is held[k] for k, t in leaves(cache))
        got.append((logits, snapshot(cache)))
    for (pl, pc), (jl, jc) in zip(got, ref["calls"]):
        assert pl.shape == (B, 1, cfg.vocab)
        close(pl, jl)
        tree_close(pc, jc)
    with torch.no_grad():
        full_logits = pm(batch)[0]
    np.testing.assert_allclose(to_np(logits[:, 0]), to_np(full_logits[:, -1]),
                               rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_specs_and_dtypes_match_reference(arch):
    """Specs (shape, logical axes, init) at batch 3, 20 slots, 5 source
    frames; the zeroed cache leaf for leaf, in the reference's final
    dtypes, bfloat16 compute included."""
    for over in ({}, {"compute_dtype": "bfloat16"}):
        jcfg, pcfg = lm_cfgs(arch, **over)
        jm, pm = JaxModel(jcfg), Model(pcfg)
        js = dict(leaves(jm.cache_specs(3, 20, src_len=5)))
        ps = dict(leaves(pm.cache_specs(3, 20, src_len=5)))
        assert {k: (v.shape, v.axes, v.init) for k, v in ps.items()} == {
            k: (v.shape, v.axes, v.init) for k, v in js.items()}
        jc = dict(leaves(jm.init_cache(3, 20, src_len=5)))
        pc = dict(leaves(pm.init_cache(3, 20, src_len=5, device="cpu")))
        assert set(pc) == set(jc)
        for key, want in jc.items():
            assert pc[key].dtype == getattr(torch, want.dtype.name), key
            np.testing.assert_array_equal(
                pc[key].float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_carries_every_leaf(arch):
    """``convert.lm_params_*`` and ``lm_cache_*`` both ways over the new
    leaves (``mu``, ``u``, ``lam``, ``conv_w``, the expert stacks,
    ``shared_*``; ``state``, ``h``, ``conv``, ``tm_prev``, ``cm_prev``,
    ``ck``, ``cv``), bit for bit, bfloat16 caches included; a tree missing
    a leaf is refused."""
    from repro_torch import convert

    from test_torch_helpers import np_params

    _, pcfg = lm_cfgs(arch)
    pm = Model(pcfg)
    tree = np_params(pm.param_specs(), 0)
    pm.load_state_dict(convert.lm_params_from_numpy(pcfg, tree, "cpu"),
                       assign=True)
    back = dict(leaves(convert.lm_params_to_numpy(pm)))
    assert set(back) == set(dict(leaves(tree)))
    for key, want in leaves(tree):
        np.testing.assert_array_equal(back[key], want)
    first = next(iter(tree))
    with pytest.raises(ValueError, match="differs"):
        convert.lm_params_from_numpy(pcfg, {k: v for k, v in tree.items()
                                            if k != first}, "cpu")
    jcfg, _ = lm_cfgs(arch, compute_dtype="bfloat16")
    jc = JaxModel(jcfg).init_cache(2, 6, src_len=3)
    pc = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for key, want in leaves(jc):
        got = dict(leaves(pc))[key]
        assert got.dtype == getattr(torch, want.dtype.name), key
    rt = dict(leaves(convert.lm_cache_to_numpy(pc)))
    for key, want in leaves(jc):
        np.testing.assert_array_equal(rt[key], np.asarray(want, np.float32)
                                      if want.dtype == jnp.bfloat16
                                      else np.asarray(want))


# ---------------------------------------------------------------------------
# the reference's decode-consistency cases, run by the port alone
# ---------------------------------------------------------------------------

BASE = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab=128, param_dtype="float32",
            compute_dtype="float32")
CONSISTENCY = {
    "dense": dict(BASE, name="t", family="dense"),
    "moe": dict(name="m", family="moe", pattern=("moe",), num_layers=2,
                d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128, vocab=128,
                moe=MoEConfig(num_experts=4, top_k=2, d_ff=32,
                              capacity_factor=4.0),
                param_dtype="float32", compute_dtype="float32"),
    "rwkv": dict(name="r", family="ssm", pattern=("rwkv",), rope="none",
                 num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
                 head_dim=16, d_ff=128, vocab=128, rwkv_head_dim=16,
                 param_dtype="float32", compute_dtype="float32"),
    "hybrid_local": dict(name="h", family="hybrid",
                         pattern=("rec", "rec", "attn"), attn_kind="local",
                         window=6, num_layers=3, d_model=64, num_heads=4,
                         num_kv_heads=1, head_dim=16, d_ff=128, vocab=128,
                         rglru_width=64, param_dtype="float32",
                         compute_dtype="float32"),
    "encdec": dict(BASE, name="e", family="audio", encdec=True,
                   enc_layers=2),
    "mrope_embeds": dict(BASE, name="t", family="vlm", rope="mrope",
                         mrope_sections=(3, 3, 2), input_mode="embeds"),
}


@pytest.mark.parametrize("case", list(CONSISTENCY))
def test_decode_consistency(case):
    """prefill(S tokens) then decoding the S+1'th equals the forward over
    S+1 tokens (rtol 1e-2, atol 2e-2), as the reference's
    ``_decode_consistency``: B 2, S 12, a cache of S + 4, 8 source
    frames."""
    from repro_torch.models import layers as L

    cfg = ModelConfig(**CONSISTENCY[case])
    m = Model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    bsz, s = 2, 12
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (bsz, s + 1)),
                          dtype=torch.int32)
    batch_full = {"tokens": tok}
    batch_pre = {"tokens": tok[:, :s]}
    if cfg.input_mode == "embeds":
        emb = L.embed({"table": m.embed.table}, cfg, tok).detach()
        batch_full, batch_pre = {"embeds": emb}, {"embeds": emb[:, :s]}
    kw = {}
    if cfg.rope == "mrope":
        pos = torch.arange(s + 1, dtype=torch.int32)[None, None].expand(
            3, bsz, s + 1)
        batch_full["positions"] = pos
        batch_pre["positions"] = pos[:, :, :s]
        kw["positions"] = torch.full((3, bsz, 1), s, dtype=torch.int32)
    if cfg.encdec:
        se = torch.as_tensor(rng.standard_normal((bsz, 8, cfg.d_model)),
                             dtype=torch.float32)
        batch_full["src_embeds"] = batch_pre["src_embeds"] = se
    with torch.no_grad():
        want = m(batch_full)[0][:, -1]
    cache = m.init_cache(bsz, s + 4, src_len=8 if cfg.encdec else 0)
    m.prefill(batch_pre, cache)
    got, _ = m.decode_step(tok[:, s:s + 1], cache, s, **kw)
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), rtol=1e-2,
                               atol=2e-2)
