"""The port's other block kinds, ``repro_torch.models.{rglru,rwkv,moe}``,
against the JAX package's ``repro.models.{rglru,rwkv,moe}``.

Parameters and inputs are drawn once with numpy and handed to both
packages by value.  Every comparison runs on the CPU in float32 within
1e-5 (rtol and atol), except where a line says otherwise: the recurrences
against a plain loop at the reference's own limits
(``tests/test_models.py``), and the chunked WKV against the scan at 1e-3 /
1e-4.  Widths are smoke widths.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro.models import rglru as JRG
from repro.models import rwkv as JRW
from repro_torch.models import layers as PL
from repro_torch.models import moe as PMOE
from repro_torch.models import rglru as PRG
from repro_torch.models import rwkv as PRW
from repro_torch.models.params import tree_items

from test_torch_helpers import lm_cfgs, to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, **tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **(tol or TOL))


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def draw(specs, rng) -> dict:
    """Numpy values for a spec tree, shaped and initialised as its specs
    say (normal leaves at their scale, uniform in +-scale)."""
    out = {}
    for path, s in tree_items(specs):
        if s.init == "zeros":
            a = np.zeros(s.shape, np.float32)
        elif s.init == "ones":
            a = np.ones(s.shape, np.float32)
        elif s.init == "uniform":
            a = rng.uniform(-s.scale, s.scale, s.shape).astype(np.float32)
        else:
            a = rand(rng, *s.shape, scale=s.scale)
        out[path] = a
    return out


def both(p: dict):
    """(reference dict of jnp arrays, port dict of tensors)."""
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


def same_specs(jspecs, pspecs):
    assert {k: (v.shape, v.axes, v.init, v.scale)
            for k, v in tree_items(pspecs)} == {
        k: (v.shape, v.axes, v.init, v.scale)
        for k, v in tree_items(jspecs)}


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d_matches_reference(carried):
    rng = np.random.default_rng(0)
    u, w, b = rand(rng, 2, 7, 16), rand(rng, 4, 16), rand(rng, 16)
    prev = rand(rng, 2, 3, 16) if carried else None
    jout, jprev = JRG._causal_conv1d(*map(jnp.asarray, (u, w, b)),
                                     None if prev is None
                                     else jnp.asarray(prev))
    pout, pprev = PRG._causal_conv1d(*map(torch.as_tensor, (u, w, b)),
                                     None if prev is None
                                     else torch.as_tensor(prev))
    close(pout, jout)
    close(pprev, jprev)


@pytest.mark.parametrize("s", [16, 13])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_scan_matches_reference_and_loop(carried, s):
    """The doubling scan against ``lax.associative_scan`` and against the
    sequential loop at ``test_rglru_assoc_scan_matches_loop``'s limits."""
    rng = np.random.default_rng(1)
    a = 1.0 / (1.0 + np.exp(-rand(rng, 2, s, 8)))
    bb = rand(rng, 2, s, 8)
    h0 = rand(rng, 2, 8) if carried else None
    want = JRG._rglru_scan(jnp.asarray(a), jnp.asarray(bb),
                           None if h0 is None else jnp.asarray(h0))
    ta, tb = torch.as_tensor(a), torch.as_tensor(bb)
    got = PRG._rglru_scan(ta, tb, None if h0 is None else torch.as_tensor(h0))
    assert torch.equal(tb, torch.as_tensor(bb))  # its input is left as is
    close(got, want)
    h = np.zeros((2, 8), np.float32) if h0 is None else h0
    loop = []
    for t in range(s):
        h = a[:, t] * h + bb[:, t]
        loop.append(h)
    close(got, np.stack(loop, axis=1), rtol=1e-4, atol=1e-5)


def test_rglru_block_prefill_then_decode_matches_reference():
    """Prefill 6 positions into a zero cache, then two one-step decodes:
    outputs and the (h, conv) cache after each call, the port's written in
    place."""
    jcfg, pcfg = lm_cfgs("recurrentgemma-9b")
    same_specs(JRG.rglru_specs(jcfg), PRG.rglru_specs(pcfg))
    rng = np.random.default_rng(2)
    p = draw(PRG.rglru_specs(pcfg), rng)
    p["conv_b"] = rand(rng, 64, scale=0.1)
    jp, tp = both(p)
    x = rand(rng, 2, 8, 64)
    jc = JRG.init_rglru_cache(jcfg, 2, jnp.float32)
    pc = PRG.init_rglru_cache(pcfg, 2, torch.float32)
    close(pc["h"], jc["h"], rtol=0, atol=0)
    close(pc["conv"], jc["conv"], rtol=0, atol=0)
    held = dict(pc)
    for lo, hi in ((0, 6), (6, 7), (7, 8)):
        jy, jc = JRG.rglru_block(jp, jcfg, jnp.asarray(x[:, lo:hi]), jc)
        py, pc = PRG.rglru_block(tp, pcfg, torch.as_tensor(x[:, lo:hi]), pc)
        close(py, jy)
        close(pc["h"], jc["h"])
        close(pc["conv"], jc["conv"])
        assert pc["h"] is held["h"] and pc["conv"] is held["conv"]
    full, none = PRG.rglru_block(tp, pcfg, torch.as_tensor(x), None)
    assert none is None
    close(full[:, 7], py[:, 0])


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def _rwkv_params(rng, pcfg):
    return draw(PRW.rwkv_specs(pcfg), rng)


def test_rwkv_specs_and_ddlerp_match_reference():
    jcfg, pcfg = lm_cfgs("rwkv6-3b")
    same_specs(JRW.rwkv_specs(jcfg), PRW.rwkv_specs(pcfg))
    assert (PRW.LORA_R, PRW.DECAY_LORA_R) == (JRW.LORA_R, JRW.DECAY_LORA_R)
    rng = np.random.default_rng(3)
    jp, tp = both(_rwkv_params(rng, pcfg))
    x, prev = rand(rng, 2, 5, 64), rand(rng, 2, 64)
    jxs = JRW._shift(jnp.asarray(x), jnp.asarray(prev))
    pxs = PRW._shift(torch.as_tensor(x), torch.as_tensor(prev))
    close(pxs, jxs, rtol=0, atol=0)
    close(PRW._shift(torch.as_tensor(x), None),
          JRW._shift(jnp.asarray(x), None), rtol=0, atol=0)
    for got, want in zip(PRW._ddlerp(tp, torch.as_tensor(x), pxs),
                         JRW._ddlerp(jp, jnp.asarray(x), jxs)):
        close(got, want)


def _wkv_inputs(rng, b, s, h, n, decay_scale=0.5):
    r, k, v = (rand(rng, b, s, h, n, scale=0.5) for _ in range(3))
    w = np.exp(-np.exp(rand(rng, b, s, h, n, scale=decay_scale)))
    return r, k, v, w.astype(np.float32), rand(rng, h, n, scale=0.5)


@pytest.mark.parametrize("carried", [False, True])
def test_wkv_scan_matches_reference(carried):
    rng = np.random.default_rng(4)
    ins = _wkv_inputs(rng, 2, 9, 3, 8)
    st = rand(rng, 2, 3, 8, 8) if carried else None
    jo, js = JRW.wkv_scan(*map(jnp.asarray, ins),
                          None if st is None else jnp.asarray(st))
    po, ps = PRW.wkv_scan(*map(torch.as_tensor, ins),
                          None if st is None else torch.as_tensor(st))
    assert ps.dtype == torch.float32 and po.dtype == torch.float32
    close(po, jo)
    close(ps, js)
    # the state is float32 and the output comes back in r's dtype
    bo, bs = PRW.wkv_scan(*(torch.as_tensor(a).bfloat16() for a in ins[:3]),
                          torch.as_tensor(ins[3]), torch.as_tensor(ins[4]))
    assert bo.dtype == torch.bfloat16 and bs.dtype == torch.float32


@pytest.mark.parametrize("b,s,chunk,carried", [(2, 64, 16, False),
                                               (1, 32, 8, True)])
def test_wkv_chunked_matches_reference_and_scan(b, s, chunk, carried):
    """The reference's two ``test_rwkv_chunked_*`` shapes: the chunked form
    against the reference's chunked form (1e-5), and against the scan at
    their limits (1e-3 / 1e-4)."""
    rng = np.random.default_rng(5)
    ins = _wkv_inputs(rng, b, s, 2 if carried else 3, 8,
                      decay_scale=1.0 if carried else 0.5)
    h, n = ins[0].shape[2:]
    st = rand(rng, b, h, n, n) if carried else None
    jst = None if st is None else jnp.asarray(st)
    pst = None if st is None else torch.as_tensor(st)
    jo, js = JRW.wkv_chunked(*map(jnp.asarray, ins), jst, chunk=chunk)
    po, ps = PRW.wkv_chunked(*map(torch.as_tensor, ins), pst, chunk=chunk)
    close(po, jo)
    close(ps, js)
    so, ss = PRW.wkv_scan(*map(torch.as_tensor, ins), pst)
    close(po, so, rtol=1e-3, atol=1e-4)
    close(ps, ss, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        PRW.wkv_chunked(*map(torch.as_tensor, ins), chunk=s // 2 + 1)


def test_wkv_chunked_masks_before_the_exp():
    """Strong decay (w near 1e-30): unmasked, exp(ex_t - cum_s) for s >= t
    is exp(+large) = inf and inf * 0 poisons the output; masked first, it
    stays finite and equal to the scan."""
    rng = np.random.default_rng(6)
    r, k, v, _, u = _wkv_inputs(rng, 1, 32, 2, 8)
    w = np.full_like(r, 1e-30)
    po, _ = PRW.wkv_chunked(*map(torch.as_tensor, (r, k, v, w, u)), chunk=32)
    so, _ = PRW.wkv_scan(*map(torch.as_tensor, (r, k, v, w, u)))
    assert torch.isfinite(po).all()
    close(po, so, rtol=1e-3, atol=1e-4)


def test_group_norm_matches_reference():
    rng = np.random.default_rng(7)
    x, w = rand(rng, 2, 5, 64) * 3 + 1, rand(rng, 64)
    close(PRW._group_norm(torch.as_tensor(x), torch.as_tensor(w), 16),
          JRW._group_norm(jnp.asarray(x), jnp.asarray(w), 16))


@pytest.mark.parametrize("chunked", [False, True])
def test_time_mix_and_channel_mix_with_a_cache_match_reference(chunked):
    """Prefill 64 positions (``use_chunked``: the chunked form, chunk 32)
    into a zero cache, then one decode step through both halves, as the
    ``rwkv`` block threads the cache: outputs and every cache leaf, the
    port's written in place."""
    jcfg, pcfg = lm_cfgs("rwkv6-3b")
    rng = np.random.default_rng(8)
    jp, tp = both(_rwkv_params(rng, pcfg))
    x = rand(rng, 2, 65, 64)
    jc = JRW.init_rwkv_cache(jcfg, 2)
    pc = PRW.init_rwkv_cache(pcfg, 2)
    for key in jc:
        close(pc[key], jc[key], rtol=0, atol=0)
    assert pc["state"].dtype == torch.float32
    held = dict(pc)
    for lo, hi in ((0, 64), (64, 65)):
        jx, px = jnp.asarray(x[:, lo:hi]), torch.as_tensor(x[:, lo:hi])
        jy, jc1 = JRW.time_mix(jp, jcfg, jx, jc, use_chunked=chunked)
        py, pc1 = PRW.time_mix(tp, pcfg, px, pc, use_chunked=chunked)
        close(py, jy, rtol=1e-4, atol=1e-5)
        jy, jc = JRW.channel_mix(jp, jcfg, jx, jc1)
        py, pc = PRW.channel_mix(tp, pcfg, px, pc1)
        close(py, jy)
        for key in jc:
            close(pc[key], jc[key], rtol=1e-4, atol=1e-5)
            assert pc[key] is held[key]
    out, none = PRW.time_mix(tp, pcfg, torch.as_tensor(x), None)
    assert none is None and out.shape == (2, 65, 64)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_cfgs(mlp, cf, shared):
    moe = dict(num_experts=8, top_k=2, d_ff=32, num_shared=shared,
               capacity_factor=cf)
    jcfg, pcfg = lm_cfgs("kimi-k2-1t-a32b", mlp=mlp)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe)),
            dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, **moe)))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("mlp", ["swiglu", "geglu"])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_ffn_matches_reference(cf, mlp, shared):
    """64 tokens over 8 experts, top 2: at capacity factor 1.0 (16 slots an
    expert, skewed routing drops some assignments) and 4.0 (none dropped);
    the output and both metrics."""
    jcfg, pcfg = _moe_cfgs(mlp, cf, shared)
    same_specs(JMOE.moe_specs(jcfg), PMOE.moe_specs(pcfg))
    rng = np.random.default_rng(9)
    p = draw(PMOE.moe_specs(pcfg), rng)
    p["router"] = rand(rng, 64, 8)  # a skewed, decisive router
    p["router"][:, 0] += 0.3
    jp, tp = both(p)
    x = rand(rng, 4, 16, 64)
    jo, jm = JMOE.moe_ffn(jp, jcfg, jnp.asarray(x))
    po, pm = PMOE.moe_ffn(tp, pcfg, torch.as_tensor(x))
    close(po, jo)
    assert set(pm) == set(jm) == {"moe_drop_frac", "moe_balance_loss"}
    for key in jm:
        close(pm[key], jm[key], rtol=1e-5, atol=1e-6)
    drop = float(pm["moe_drop_frac"])
    assert (drop > 0) if cf == 1.0 else (drop == 0)


def test_capacity_matches_reference():
    jcfg, pcfg = _moe_cfgs("swiglu", 1.25, 0)
    for t in (1, 4, 8, 100, 2048, 10_000):
        assert PMOE.capacity(pcfg, t) == JMOE.capacity(jcfg, t)


def test_moe_ffn_raises_under_a_sharding_hook(monkeypatch):
    """Expert parallelism needs the production mesh: with a hook (or a
    mesh) in place, moe_ffn names the item that holds it."""
    _, pcfg = _moe_cfgs("swiglu", 1.25, 0)
    p = {k: torch.as_tensor(v) for k, v in draw(
        PMOE.moe_specs(pcfg), np.random.default_rng(10)).items()}
    x = torch.zeros((1, 4, 64))
    assert PL.get_mesh() is None and not PL.sharded()
    PMOE.moe_ffn(p, pcfg, x)
    monkeypatch.setattr(PL, "_SHARDING_HOOK", lambda a, axes: a)
    with pytest.raises(NotImplementedError, match="item 10b-3"):
        PMOE.moe_ffn(p, pcfg, x)
    monkeypatch.setattr(PL, "_SHARDING_HOOK", None)
    monkeypatch.setattr(PL, "_MESH", object())
    with pytest.raises(NotImplementedError, match="item 10b-3"):
        PMOE.moe_ffn(p, pcfg, x)
