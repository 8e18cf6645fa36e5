"""The port's LM substrate, ``repro_torch.models`` and ``repro_torch.configs``,
against the JAX package's ``repro.models`` and ``repro.configs``.

Parameters are built once by the reference and handed to the port by value
(``convert.lm_params_from_numpy``); inputs are drawn with numpy.  Every
comparison runs on the CPU in float32 within 1e-4 (rtol and atol), except
the bfloat16 case, held at bfloat16's resolution.  Models are never wider
than ``smoke_of``: the full-width checks (configs, parameter counts, the
abstract parameter tree, cache shapes) allocate nothing, the port's side
living on the ``meta`` device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro.models import params as jparams_mod
from repro.models.config import (SHAPES as JSHAPES, SUBQUADRATIC as JSUBQ,
                                 cell_is_skipped as jskip)
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.models import Model
from repro_torch.models import layers as PL
from repro_torch.models import params as pparams_mod
from repro_torch.models.config import SHAPES, SUBQUADRATIC, cell_is_skipped

from test_torch_helpers import lm_cfgs, lm_pair, to_np

TOL = dict(rtol=1e-4, atol=1e-4)
# the three smoke models of the parity checks: GQA + SwiGLU + tied
# embeddings; GeGLU + scaled embeddings (MHA); local attention (ring cache)
SMOKE_MODELS = {
    "llama": ("llama3.2-3b", {}),
    "gemma": ("gemma-7b", {}),
    "local": ("llama3.2-3b", dict(name="llama3.2-3b-local-smoke",
                                  attn_kind="local", window=8)),
}


def close(got, want, **tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **(tol or TOL))


def tree_close(got, want, **tol):
    got, want = to_np(got), to_np(want)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            tree_close(got[k], want[k], **tol)
        else:
            close(got[k], want[k], **tol)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def specs_of(tree, is_leaf):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if is_leaf(v):
            out[k] = v
        else:
            out.update({f"{k}.{p}": x for p, x in specs_of(v, is_leaf).items()})
    return out


# ---------------------------------------------------------------------------
# configs: every preset, field for field, without allocating
# ---------------------------------------------------------------------------

def test_arch_names_match():
    assert pconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_config_matches_reference(arch):
    j, p = jconfigs.get(arch), pconfigs.get(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.param_count() == j.param_count()
    assert p.active_param_count() == j.active_param_count()
    assert p.layer_plan == j.layer_plan
    assert p.q_per_kv == j.q_per_kv
    assert p.attn_param_count == j.attn_param_count
    assert p.pdtype == getattr(torch, str(j.pdtype))
    assert p.cdtype == getattr(torch, str(j.cdtype))
    js, ps = jconfigs.smoke_of(j), pconfigs.smoke_of(p)
    assert dataclasses.asdict(ps) == dataclasses.asdict(js)
    assert ps.param_count() == js.param_count()
    for name, shape in JSHAPES.items():
        jb = jconfigs.batch_shapes(j, shape)
        pb = pconfigs.batch_shapes(p, SHAPES[name])
        assert {k: (s, getattr(torch, jnp.dtype(d).name), kind)
                for k, (s, d, kind) in jb.items()} == pb
        assert pconfigs.src_len(p, SHAPES[name]) == jconfigs.src_len(j, shape)


def test_shape_and_workload_tables_match():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert {k: v.step_name for k, v in SHAPES.items()} == {
        k: v.step_name for k, v in JSHAPES.items()}
    assert SUBQUADRATIC == JSUBQ
    for arch in jconfigs.ARCH_NAMES:
        for shape in JSHAPES:
            assert cell_is_skipped(arch, shape) == jskip(arch, shape)
    assert pconfigs.CPALS_WORKLOADS == jconfigs.CPALS_WORKLOADS
    assert pconfigs.CPALS_DATASET == jconfigs.CPALS_DATASET
    with pytest.raises(KeyError, match="unknown arch"):
        pconfigs.get("gpt-5")


def test_layer_plan_refuses_a_bad_split():
    cfg = dataclasses.replace(pconfigs.get("recurrentgemma-9b"), num_layers=37)
    with pytest.raises(ValueError, match="does not decompose"):
        cfg.layer_plan


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_full_width_abstract_params_match_reference(arch):
    """The full published width, on the meta device: every leaf path,
    shape and dtype of the reference's ShapeDtypeStructs; the parameter
    count (the config's ``param_count`` estimate for the dense family); param
    bytes; the
    decode cache's shapes at a 4128-slot cache (16 source frames for the
    encoder-decoder)."""
    jm, pm = JaxModel(jconfigs.get(arch)), Model(pconfigs.get(arch))
    want = specs_of(jm.abstract(), lambda v: isinstance(v, jax.ShapeDtypeStruct))
    got = specs_of(pm.abstract(), torch.is_tensor)
    assert set(got) == set(want)
    for path, s in want.items():
        assert got[path].device.type == "meta"
        assert tuple(got[path].shape) == s.shape, path
        assert got[path].dtype == getattr(torch, s.dtype.name), path
    sd = pm.state_dict()
    assert set(sd) == set(want)
    assert all(t.device.type == "meta" for t in sd.values())
    n_ref = sum(int(np.prod(s.shape)) for s in want.values())
    assert sum(t.numel() for t in sd.values()) == n_ref
    if pm.cfg.family == "dense":  # the config's estimate is exact there
        assert n_ref == pm.cfg.param_count()
    assert (pparams_mod.param_bytes(pm.param_specs(), pm.cfg.pdtype)
            == jparams_mod.param_bytes(jm.param_specs(), jm.cfg.pdtype))
    jc = specs_of(jm.cache_specs(4, 4128, src_len=16),
                  lambda v: isinstance(v, jparams_mod.ParamSpec))
    pc = specs_of(pm.cache_specs(4, 4128, src_len=16),
                  lambda v: isinstance(v, pparams_mod.ParamSpec))
    assert {k: (v.shape, v.axes, v.init) for k, v in pc.items()} == {
        k: (v.shape, v.axes, v.init) for k, v in jc.items()}


def test_unported_pieces_raise():
    with pytest.raises(NotImplementedError, match="item 10b-3"):
        PL.set_sharding_hook(lambda x, axes: x)
    PL.set_sharding_hook(None)
    x = torch.ones(2)
    assert PL.shard_act(x, ("act_batch",)) is x


# ---------------------------------------------------------------------------
# parameters: init on a device from a generator, bridges, the cache
# ---------------------------------------------------------------------------

def test_init_draws_from_the_generator():
    cfg = pconfigs.smoke_of(pconfigs.get("gemma-7b"))
    a = Model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    b = Model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    c = Model(cfg).init(torch.Generator().manual_seed(4), "cpu")
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert x.device.type == "cpu" and x.dtype == torch.float32
        assert torch.equal(x, y), k
        if k.endswith(".w"):  # rmsnorm weights: ones
            assert torch.equal(x, torch.ones_like(x)) and torch.equal(x, z)
        else:
            assert not torch.equal(x, z), k
            assert abs(float(x.std()) - 0.02) < 3e-3, k
    spec = pparams_mod.ParamSpec((4000,), ("x",), "uniform", 0.5)
    u = pparams_mod.init_params({"u": spec}, torch.Generator().manual_seed(0),
                                torch.float32, torch.device("cpu"))["u"]
    assert float(u.min()) >= -0.5 and float(u.max()) <= 0.5
    assert float(u.min()) < -0.45 and float(u.max()) > 0.45
    with pytest.raises(ValueError):
        pparams_mod.ParamSpec((2, 3), ("x",))


def test_params_bridge_round_trips():
    _, jp, pm = lm_pair("llama3.2-3b")
    want = to_np(jax.tree.map(np.asarray, jp))
    tree_close(convert.lm_params_to_numpy(pm), want, rtol=0, atol=0)
    assert pm.params()["stack"]["b0"]["attn"]["wq"] is \
        pm.stack.b0.attn.wq
    bad = dict(want, final_norm={"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="differs"):
        convert.lm_params_from_numpy(pm.cfg, bad, "cpu")


def test_bf16_leaves_cross_by_bits():
    a = np.asarray(jnp.linspace(-3, 3, 11, dtype=jnp.bfloat16))
    t = convert.lm_cache_from_numpy({"k": a}, "cpu")["k"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.lm_cache_to_numpy({"k": t})["k"],
                                  a.astype(np.float32))


@pytest.mark.parametrize("name", ["llama", "local"])
def test_init_cache_matches_reference(name):
    arch, over = SMOKE_MODELS[name]
    jcfg, pcfg = lm_cfgs(arch, **over)
    jc = to_np(JaxModel(jcfg).init_cache(3, 20))
    pc = Model(pcfg).init_cache(3, 20, device="cpu")
    tree_close(pc, jc, rtol=0, atol=0)
    leaf = pc["stack"]["b0"]["self"]
    assert leaf["slot_pos"].dtype == torch.int32
    assert leaf["k"].dtype == leaf["v"].dtype == pcfg.cdtype
    assert int(leaf["slot_pos"][0, 0]) == 2 ** 30


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(norm):
    jcfg, pcfg = lm_cfgs("llama3.2-3b", norm=norm)
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 5, 64) * 3 + 1
    p = {"w": rand(rng, 64), "b": rand(rng, 64)}
    if norm == "rmsnorm":
        p.pop("b")
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                         jnp.asarray(x))
    got = PL.apply_norm({k: torch.as_tensor(v) for k, v in p.items()}, pcfg,
                        torch.as_tensor(x))
    close(got, want)


@pytest.mark.parametrize("rope", ["std", "mrope"])
def test_rope_matches_reference(rope):
    over = dict(rope=rope, rope_theta=500_000.0)
    jcfg, pcfg = lm_cfgs("qwen2-vl-7b" if rope == "mrope" else "llama3.2-3b",
                         **over)
    rng = np.random.default_rng(1)
    q, k = rand(rng, 2, 7, 4, 16), rand(rng, 2, 7, 2, 16)
    shape = (3, 2, 7) if rope == "mrope" else (2, 7)
    pos = rng.integers(0, 5000, shape).astype(np.int32)
    jq, jk = JL.apply_rope(jcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(pos))
    pq, pk = PL.apply_rope(pcfg, torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(pos))
    close(pq, jq)
    close(pk, jk)
    if rope == "mrope":
        close(PL.mrope_sincos(torch.as_tensor(pos), 16, 1e6, (2, 3, 3))[0],
              JL.mrope_sincos(jnp.asarray(pos), 16, 1e6, (2, 3, 3))[0])
        with pytest.raises(ValueError, match="sum"):
            PL.mrope_sincos(torch.as_tensor(pos), 16, 1e6, (2, 3, 4))


@pytest.mark.parametrize("kind", ["causal", "bidir", "local"])
def test_train_mask_matches_reference(kind):
    np.testing.assert_array_equal(PL._train_mask(kind, 13, 4).numpy(),
                                  np.asarray(JL._train_mask(kind, 13, 4)))


def _qkv(rng, b=2, s=64, t=64, h=4, kv=2, hd=16):
    return rand(rng, b, s, h, hd), rand(rng, b, t, kv, hd), rand(rng, b, t, kv, hd)


@pytest.mark.parametrize("kind", ["causal", "bidir", "local"])
def test_sdpa_matches_reference(kind):
    jcfg, pcfg = lm_cfgs("llama3.2-3b", window=8)
    q, k, v = _qkv(np.random.default_rng(2), s=24, t=24)
    mask = np.asarray(JL._train_mask(kind, 24, 8))[None, None, None]
    want = JL._sdpa(jcfg, *map(jnp.asarray, (q, k, v)), jnp.asarray(mask))
    got = PL._sdpa(pcfg, *map(torch.as_tensor, (q, k, v)),
                   torch.as_tensor(mask))
    close(got, want)


@pytest.mark.parametrize("block_skip", [False, True])
@pytest.mark.parametrize("kind", ["causal", "bidir", "local"])
def test_flash_attention_matches_reference(kind, block_skip):
    """Small blocks (qb = kb = 16 over 64 positions), GQA g = 2; and the
    port's flash step equals its own sdpa."""
    jcfg, pcfg = lm_cfgs("llama3.2-3b", window=20)
    q, k, v = _qkv(np.random.default_rng(3))
    want = JL._flash_attention(jcfg, *map(jnp.asarray, (q, k, v)), kind,
                               qb=16, kb=16, block_skip=block_skip)
    pq, pk, pv = map(torch.as_tensor, (q, k, v))
    got = PL._flash_attention(pcfg, pq, pk, pv, kind, qb=16, kb=16,
                              block_skip=block_skip)
    close(got, want)
    mask = PL._train_mask(kind, 64, 20)[None, None, None]
    close(got, PL._sdpa(pcfg, pq, pk, pv, mask), rtol=1e-5, atol=1e-5)


def test_gqa_reads_kv_head_h_over_g():
    """Head h of a GQA layer attends with KV head h // g (repeat, not
    tile): a KV head set to zero values silences exactly its query heads."""
    _, pcfg = lm_cfgs("llama3.2-3b")
    q, k, v = map(torch.as_tensor, _qkv(np.random.default_rng(4), s=32,
                                        t=32))
    v[:, :, 1] = 0.0
    for out in (PL._flash_attention(pcfg, q, k, v, "causal", qb=16, kb=16),
                PL._sdpa(pcfg, q, k, v,
                         PL._train_mask("causal", 32, 0)[None, None, None])):
        assert out[:, :, 2:].abs().max() == 0  # heads 2, 3 read KV head 1
        assert out[:, :, :2].abs().max() > 0


def _attn_params(rng, d=64, h=4, kv=2, hd=16):
    return {"wq": rand(rng, d, h, hd) * 0.1, "wk": rand(rng, d, kv, hd) * 0.1,
            "wv": rand(rng, d, kv, hd) * 0.1, "wo": rand(rng, h, hd, d) * 0.1}


@pytest.mark.parametrize("kind", ["causal", "local"])
def test_attention_prefill_then_decode_matches_reference(kind):
    """Prefill 12 tokens into a 16-slot cache (``local``: an 8-slot ring,
    rolled), then decode 4 tokens one at a time: outputs and caches."""
    over = dict(attn_kind="local", window=8) if kind == "local" else {}
    jcfg, pcfg = lm_cfgs("llama3.2-3b", **over)
    rng = np.random.default_rng(5)
    p = _attn_params(rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = rand(rng, 2, 16, 64)
    cap = 8 if kind == "local" else 16
    cache = {"k": np.zeros((2, cap, 2, 16), np.float32),
             "v": np.zeros((2, cap, 2, 16), np.float32),
             "slot_pos": np.full((cap,), 2 ** 30, np.int32)}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    pc = convert.lm_cache_from_numpy(cache, "cpu")
    jy, jc = JL.attention(jp, jcfg, jnp.asarray(x[:, :12]), mask_kind=kind,
                          cache=jc)
    py, pc = PL.attention(tp, pcfg, torch.as_tensor(x[:, :12]),
                          mask_kind=kind, cache=pc)
    close(py, jy)
    tree_close(pc, jc)
    for pos in range(12, 16):
        jy, jc = JL.attention(jp, jcfg, jnp.asarray(x[:, pos:pos + 1]),
                              mask_kind=kind, cache=jc,
                              pos=jnp.array(pos, jnp.int32))
        py, pc = PL.attention(tp, pcfg, torch.as_tensor(x[:, pos:pos + 1]),
                              mask_kind=kind, cache=pc, pos=pos)
        close(py, jy)
        tree_close(pc, jc)


def test_attention_takes_the_flash_path_at_4096():
    """At s = 4096 both packages dispatch to the blockwise kernel
    (qb = 256, kb = 1024); batch 1, smoke width."""
    jcfg, pcfg = lm_cfgs("llama3.2-3b")
    rng = np.random.default_rng(6)
    p = _attn_params(rng)
    x = rand(rng, 1, 4096, 64)
    want = JL.attention({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                        jnp.asarray(x), mask_kind="causal")[0]
    got = PL.attention({k: torch.as_tensor(v) for k, v in p.items()}, pcfg,
                       torch.as_tensor(x), mask_kind="causal")[0]
    close(got, want)


def test_cross_attention_matches_reference():
    jcfg, pcfg = lm_cfgs("llama3.2-3b")
    rng = np.random.default_rng(7)
    p = _attn_params(rng)
    x, mem = rand(rng, 2, 5, 64), rand(rng, 2, 9, 64)
    jy, jc = JL.attention({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                          jnp.asarray(x), mask_kind="bidir",
                          memory=jnp.asarray(mem), cache={})
    py, pc = PL.attention({k: torch.as_tensor(v) for k, v in p.items()},
                          pcfg, torch.as_tensor(x), mask_kind="bidir",
                          memory=torch.as_tensor(mem), cache={})
    close(py, jy)
    tree_close(pc, jc)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    jcfg, pcfg = lm_cfgs("llama3.2-3b", mlp=kind)
    rng = np.random.default_rng(8)
    p = {"wg": rand(rng, 64, 128) * 0.3, "wu": rand(rng, 64, 128) * 0.3,
         "wd": rand(rng, 128, 64) * 0.1}
    if kind == "gelu":
        p.pop("wg")
    x = rand(rng, 2, 5, 64)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                  jnp.asarray(x))
    got = PL.mlp({k: torch.as_tensor(v) for k, v in p.items()}, pcfg,
                 torch.as_tensor(x))
    close(got, want)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-7b", "yi-34b"])
def test_embed_unembed_match_reference(arch):
    jcfg, pcfg = lm_cfgs(arch)
    rng = np.random.default_rng(9)
    p = {"table": rand(rng, 512, 64), "head": rand(rng, 64, 512)}
    if pcfg.tie_embeddings:
        p.pop("head")
    tok = rng.integers(0, 512, (2, 6)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jx = JL.embed(jp, jcfg, jnp.asarray(tok))
    px = PL.embed(tp, pcfg, torch.as_tensor(tok))
    close(px, jx)
    close(PL.unembed(tp, pcfg, px), JL.unembed(jp, jcfg, jx))


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(SMOKE_MODELS))
def pair(request):
    arch, over = SMOKE_MODELS[request.param]
    return lm_pair(arch, **over)


def test_forward_matches_reference(pair):
    jm, jp, pm = pair
    tok = np.random.default_rng(10).integers(0, 512, (2, 13)).astype(np.int32)
    want, _, wm = jm.forward(jp, {"tokens": jnp.asarray(tok)}, mode="train")
    with torch.no_grad():
        got, gc, gm = pm.forward({"tokens": torch.as_tensor(tok)})
        hid, _, _ = pm({"tokens": torch.as_tensor(tok)}, mode="hidden")
    assert gc is None and gm == {} and wm == {}
    assert got.shape == (2, 13, 512) and hid.shape == (2, 13, 64)
    close(got, want)
    close(hid, jm.forward(jp, {"tokens": jnp.asarray(tok)}, mode="hidden")[0])


def test_prefill_and_decode_match_reference(pair):
    """Prefill 10 tokens into a 16-slot cache, then 5 decode steps: the
    logits and the whole cache after every call; and the last step equals
    the forward over all 15 tokens at the reference's decode limits."""
    jm, jp, pm = pair
    tok = np.random.default_rng(11).integers(0, 512, (2, 15)).astype(np.int32)
    jc = jm.init_cache(2, 16)
    pc = pm.init_cache(2, 16)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :10])}, jc)
    pl, pc = pm.prefill({"tokens": torch.as_tensor(tok[:, :10])}, pc)
    assert pl.shape == (2, 1, 512)
    close(pl, jl)
    tree_close(pc, jc)
    for pos in range(10, 15):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok[:, pos:pos + 1]), jc,
                                jnp.array(pos, jnp.int32))
        pl, pc = pm.decode_step(torch.as_tensor(tok[:, pos:pos + 1]), pc,
                                pos)
        close(pl, jl)
        tree_close(pc, jc)
    with torch.no_grad():
        full, _, _ = pm({"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(to_np(pl[:, 0]), to_np(full[:, -1]),
                               rtol=1e-2, atol=2e-2)


def test_decode_refuses_a_position_past_the_cache():
    _, _, pm = lm_pair("llama3.2-3b")
    cache = pm.init_cache(1, 4)
    with pytest.raises(ValueError, match="past the cache"):
        pm.decode_step(torch.zeros((1, 1), dtype=torch.int32), cache, 4)


def test_bf16_forward_tracks_reference():
    """param and compute dtype bfloat16: the same parameter bits in both
    packages, logits within bfloat16's resolution of the reference's."""
    jm, jp, pm = lm_pair("llama3.2-3b", param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    assert pm.embed.table.dtype == torch.bfloat16
    tok = np.random.default_rng(12).integers(0, 512, (2, 9)).astype(np.int32)
    want, _, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, _, _ = pm({"tokens": torch.as_tensor(tok)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)
