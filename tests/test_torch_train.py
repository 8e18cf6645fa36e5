"""LM training in the port against the JAX package: the optimizers, int8
gradient compression, the token pipeline, ``Model.loss`` and its gradients
for every preset (the flash path included), the train step, the optimizer
state carried across, and ``train()`` resumed from a checkpoint the
reference wrote.

The same numpy inputs go to both sides; parameters pass through
``convert.lm_params_from_numpy``.  Tolerances: optimizer updates and state
within 1e-6 (a bfloat16 parameter within one bfloat16 ulp); the int8
payload and the batches bit for bit; losses within 1e-5; gradients rtol
1e-4 / atol 1e-5; each of 3 train steps within 1e-5 (losses) and 1e-4
(parameters, state); ``train()`` losses within 1e-4 a step.  Every model
is at ``smoke_of`` width.
"""
import dataclasses
import runpy
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.data import TokenPipeline as JaxPipeline
from repro.data import make_batch_iterator as jax_batch_iterator
from repro.dist import compress as JC
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import Model as JaxModel
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch import optim as PO
from repro_torch.data import TokenPipeline, make_batch_iterator
from repro_torch.dist import compress as PC
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model

from test_torch_helpers import lm_cfgs, np_params

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def f32(x) -> np.ndarray:
    """A JAX array or a torch tensor (bfloat16 widened exactly) as float32
    numpy, or an integer one as it is."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def flat(tree, prefix=""):
    """``{dotted path: leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def tree_close(got, want, **tol):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(f32(got[k]), f32(want[k]), err_msg=k,
                                   **tol)


def within_bf16_ulp(got, want, what):
    """Each bfloat16 value within one bfloat16 ulp of the reference's."""
    got, want = f32(got), f32(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), what


def to_torch(tree):
    """A numpy tree (ml_dtypes bfloat16 leaves included) as CPU tensors."""
    return convert.lm_opt_state_from_numpy(tree, "cpu")


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# (i) the optimizers
# ---------------------------------------------------------------------------

def _opt_tree(rng, scale=1.0):
    """Float32 leaves of 1-3 dims and a bfloat16 matrix."""
    def r(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"a": {"w": r(4, 8), "b": r(7)}, "s": {"w": r(3, 5, 6)},
            "h": np.asarray(jnp.asarray(r(6, 4), jnp.bfloat16))}


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.1, "clip_norm": 0.5}),
    ("adafactor", {}),
    ("adafactor", {"clip_norm": 0.0}),
])
def test_optimizer_matches_reference(name, kw):
    """5 steps of ``update`` from the same tree and gradients: every float32
    parameter and state leaf within 1e-6, the bfloat16 parameter within one
    bfloat16 ulp; the state keeps the reference's paths, all float32; the
    port writes the parameters (and state) in place."""
    rng = np.random.default_rng(0)
    tree = _opt_tree(rng)
    jp, pp = to_jax(tree), to_torch(tree)
    ptensors = flat(pp)
    jopt = JO.OPTIMIZERS[name](lr=1e-2, **kw)
    popt = PO.OPTIMIZERS[name](lr=1e-2, **kw)
    js, ps = jopt.init(jp), popt.init(pp)
    assert all(t.dtype == torch.float32 for t in flat(ps).values())
    for step in range(5):
        grads = _opt_tree(rng, scale=3.0)
        jp, js = jopt.update(to_jax(grads), js, jp, jnp.int32(step))
        ps = popt.update(to_torch(grads), ps, pp, step)
        tree_close(ps, js, rtol=1e-6, atol=1e-6)
        for k, t in flat(pp).items():
            assert t is ptensors[k]
            if k == "h":
                assert t.dtype == torch.bfloat16
                within_bf16_ulp(t, flat(jp)[k], k)
            else:
                np.testing.assert_allclose(f32(t), f32(flat(jp)[k]),
                                           rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 1e6, 0.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    """The global norm within 1e-6; float32 leaves within 1e-6 and the
    bfloat16 one within a bfloat16 ulp (clipping, no clipping, disabled)."""
    tree = _opt_tree(np.random.default_rng(1), scale=2.0)
    jg, jn = JO.clip_by_global_norm(to_jax(tree), max_norm)
    pg, pn = PO.clip_by_global_norm(to_torch(tree), max_norm)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    for k, t in flat(pg).items():
        if k == "h":
            within_bf16_ulp(t, flat(jg)[k], k)
        else:
            np.testing.assert_allclose(f32(t), f32(flat(jg)[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_state_axes_match_reference():
    axes = {"w": ("embed", "mlp"), "s": ("layers", "embed", "heads"),
            "b": ("embed",)}
    for name in ("adamw", "adafactor"):
        assert (PO.OPTIMIZERS[name]().state_axes(axes)
                == JO.OPTIMIZERS[name]().state_axes(axes))
    assert set(PO.OPTIMIZERS) == set(JO.OPTIMIZERS)


# ---------------------------------------------------------------------------
# (ii) int8 gradient compression
# ---------------------------------------------------------------------------

def test_compress_grads_int8_matches_reference():
    """Two rounds with the residual carried: the int8 payload bit for bit,
    scales and residuals within 1e-7, the dequantised gradients, the
    integer pass-through, an all-zero leaf, ``compression_ratio``."""
    rng = np.random.default_rng(2)

    def grads():
        t = _opt_tree(rng, scale=0.3)
        t["z"] = np.zeros((5,), np.float32)
        t["i"] = rng.integers(-9, 9, (3,)).astype(np.int32)
        return t

    jef = pef = None
    for _ in range(2):
        g = grads()
        jq, js, jef = JC.compress_grads_int8(to_jax(g), jef)
        pq, ps, pef = PC.compress_grads_int8(to_torch(g), pef)
        for k, q in flat(pq).items():
            want = np.asarray(flat(jq)[k])
            assert f32(q).dtype == want.dtype, k
            np.testing.assert_array_equal(f32(q), want, err_msg=k)
        tree_close(ps, js, rtol=0, atol=1e-7)
        tree_close(pef, jef, rtol=0, atol=1e-7)
        tree_close(PC.decompress_grads_int8(pq, ps),
                   JC.decompress_grads_int8(jq, js), rtol=0, atol=1e-7)
        assert (PC.compression_ratio(to_torch(g))
                == JC.compression_ratio(to_jax(g)))
    with pytest.raises(ValueError, match="does not match"):
        PC.compress_grads_int8(to_torch(grads()), {"a": pef["a"]})


# ---------------------------------------------------------------------------
# (iii) the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-vl-7b",
                                  "seamless-m4t-large-v2"])
def test_pipeline_batches_are_the_reference_bits(arch):
    """Tokens, ``embeds`` with M-RoPE positions, an encoder-decoder's source
    frames: every leaf bit for bit and of the same dtype, whole and through
    ``host_slice``; the iterators from a start step too."""
    jcfg, pcfg = lm_cfgs(arch)
    for index, hs in ((0, None), (7, slice(1, 3))):
        jb = JaxPipeline(jcfg, 4, 24, seed=3).batch_at(index, host_slice=hs)
        pb = TokenPipeline(pcfg, 4, 24, seed=3, device="cpu").batch_at(
            index, host_slice=hs)
        assert set(pb) == set(jb)
        for k in jb:
            want = np.asarray(jb[k])
            assert pb[k].device.type == "cpu"
            assert pb[k].numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(pb[k].numpy(), want, err_msg=k)
    jit = jax_batch_iterator(jcfg, 2, 8, seed=1, start_step=5)
    pit = make_batch_iterator(pcfg, 2, 8, seed=1, start_step=5, device="cpu")
    for _ in range(2):
        jb, pb = next(jit), next(pit)
        for k in jb:
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# (iv) Model.loss and its gradients, every preset
# ---------------------------------------------------------------------------

def pair(arch, seed=0, **over):
    """The same smoke model in both packages (numpy-drawn parameters); the
    MoE presets at capacity factor 1.0, where tokens are dropped."""
    jcfg, pcfg = lm_cfgs(arch, **over)
    if jcfg.moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=1.0))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=1.0))
    pm = Model(pcfg)
    tree = np_params(pm.param_specs(), seed)
    pm.load_state_dict(convert.lm_params_from_numpy(pcfg, tree, "cpu"),
                       assign=True)
    return JaxModel(jcfg), to_jax(tree), pm


def np_batch(cfg, batch, seq, index=0, seed=1):
    """The reference pipeline's batch ``index`` as numpy, the first three
    labels of row 0 masked (-1)."""
    b = {k: np.array(v) for k, v in
         JaxPipeline(cfg, batch, seq, seed=seed).batch_at(index).items()}
    b["labels"][0, :3] = -1
    return b


def port_grads(pm):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad)
            for k, p in pm.named_parameters()}


def check_loss_and_grads(jm, jp, pm, batch):
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, to_jax(batch))
    pm.zero_grad(set_to_none=True)
    pl, pmet = pm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **LOSS_TOL)
    assert set(pmet) == set(jmet) and pmet["loss"] is pl
    for k in jmet:
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]),
                                   **LOSS_TOL)
    jflat = flat(jg)
    pflat = port_grads(pm)
    assert set(pflat) == set(jflat)
    for k, g in pflat.items():
        np.testing.assert_allclose(f32(g), f32(jflat[k]), err_msg=k,
                                   **GRAD_TOL)
    return float(pl)


@pytest.mark.parametrize("arch", pconfigs.ARCH_NAMES)
def test_loss_and_grads_match_reference(arch):
    """Every preset's ``smoke_of`` (MoE at capacity factor 1.0), batch 2,
    16 positions, some labels masked: the loss and the metrics within 1e-5,
    every gradient leaf within rtol 1e-4 / atol 1e-5."""
    jm, jp, pm = pair(arch)
    check_loss_and_grads(jm, jp, pm, np_batch(jm.cfg, 2, 16))


def test_chunked_loss_matches_reference_and_the_full_loss():
    """``chunked_loss=8`` over 16 positions: against the reference's chunked
    loss and grads, and the port's full loss within 1e-6."""
    jm, jp, pm = pair("llama3.2-3b", chunked_loss=8)
    batch = np_batch(jm.cfg, 2, 16)
    chunked = check_loss_and_grads(jm, jp, pm, batch)
    _, _, full = pair("llama3.2-3b")
    with torch.no_grad():
        whole, _ = full.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    np.testing.assert_allclose(chunked, float(whole), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of chunked_loss"):
        pm.loss({k: torch.from_numpy(v[:, :12]) for k, v in batch.items()})


@pytest.mark.parametrize("block_skip", [False, True])
def test_flash_path_loss_and_grads_match_reference(block_skip):
    """Batch 1 at 4096 positions, where attention is ``_flash_attention``
    (its carries rebuilt out of place, so autograd can go back through it),
    with and without ``flash_block_skip``; one layer of two query heads on
    one KV head, to keep the saved score blocks small."""
    jm, jp, pm = pair("llama3.2-3b", flash_block_skip=block_skip,
                      num_layers=1, num_heads=2, num_kv_heads=1)
    check_loss_and_grads(jm, jp, pm, np_batch(jm.cfg, 1, 4096))


# ---------------------------------------------------------------------------
# (v) the train step
# ---------------------------------------------------------------------------

def mostly_close(got, want, share, **tol):
    """Every leaf of ``got`` within ``tol`` of ``want``, but for at most
    ``share`` of its elements."""
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k in want:
        g, w = f32(got[k]), f32(want[k])
        assert g.shape == w.shape, k
        bad = ~np.isclose(g, w, **tol)
        assert bad.mean() <= share, (k, int(bad.sum()), g.size,
                                     float(np.abs(g - w).max()))


@pytest.mark.parametrize("opt,micro,compress,remat", [
    ("adamw", 1, False, "off"),
    ("adamw", 2, True, "full"),
    ("adafactor", 2, False, "dots"),
    ("adafactor", 1, True, "full"),
    ("adamw", 1, False, "dots"),
])
def test_train_step_matches_reference(opt, micro, compress, remat):
    """3 steps of ``make_train_step`` against the reference's jitted step
    (batch 4, 16 positions, lr 1e-2), each step from the reference's
    parameters and state of the step before (copied into the port's
    tensors): the loss within 1e-5, ``step`` + 1, every parameter and state
    leaf within rtol 1e-4 / atol 1e-4 (Adam moves a weight whose gradient
    is near 0 by up to lr on the gradient's sign, so its parameters are held
    in absolute terms).  With ``grad_compress`` a gradient within 1e-6 of
    the reference's can sit on the other side of an int8 rounding boundary
    (one code, then up to lr in that weight): there at most 1e-3 of a
    leaf's elements may differ."""
    over = dict(remat=remat != "off",
                remat_policy="dots" if remat == "dots" else "full")
    jm, jp, pm = pair("llama3.2-3b", **over)
    jopt = JO.OPTIMIZERS[opt](lr=1e-2)
    popt = PO.OPTIMIZERS[opt](lr=1e-2)
    js = jopt.init(jp)
    if compress:
        js = dict(js, ef=JC.init_error_feedback(jp))
    jstep = jax.jit(jax_make_train_step(jm, jopt, grad_compress=compress,
                                        micro_batches=micro))
    pstep = make_train_step(pm, popt, grad_compress=compress,
                            micro_batches=micro)
    params = pm.params()
    share = 1e-3 if compress else 0.0
    for step in range(3):
        with torch.no_grad():
            for k, p in flat(params).items():
                p.copy_(torch.tensor(f32(flat(jp)[k])))
        ps = convert.lm_opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                             "cpu")
        batch = np_batch(jm.cfg, 4, 16, index=step)
        jp, js, jmet = jstep(jp, js, to_jax(batch), jnp.int32(step))
        ps, pmet = pstep(ps, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, step)
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   **LOSS_TOL)
        assert pmet["step"] == int(jmet["step"]) == step + 1
        mostly_close(params, jp, share, rtol=1e-4, atol=1e-4)
        mostly_close(ps, js, share, rtol=1e-4, atol=1e-4)
        assert all(p.grad is None for p in pm.parameters())


def test_remat_dots_keeps_the_products_without_batch_dims():
    """Under remat the backward recomputes each rep: with ``"full"`` its
    products too, with ``"dots"`` none of those without batch dims (the
    same count of them as with remat off), and the gradients equal."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is aten.mm.default or (func is aten.bmm.default
                                           and args[0].shape[0] == 1):
                self.n += 1
            return func(*args, **(kwargs or {}))

    batch = {k: torch.from_numpy(v) for k, v in
             np_batch(lm_cfgs("llama3.2-3b")[0], 2, 16).items()}
    counts, grads = {}, {}
    for remat in ("off", "full", "dots"):
        _, _, pm = pair("llama3.2-3b", remat=remat != "off",
                        remat_policy="dots" if remat == "dots" else "full")
        loss, _ = pm.loss(batch)
        with Count() as c:
            loss.backward()
        counts[remat] = c.n
        grads[remat] = port_grads(pm)
    assert counts["dots"] == counts["off"] < counts["full"], counts
    for remat in ("full", "dots"):
        for k, g in grads[remat].items():
            torch.testing.assert_close(g, grads["off"][k], rtol=0, atol=0)


def test_split_micro_matches_reference():
    from repro.launch.steps import _split_micro as jsplit
    from repro_torch.launch.steps import _split_micro as psplit

    _, pcfg = lm_cfgs("qwen2-vl-7b")
    batch = TokenPipeline(pcfg, 4, 6, seed=0, device="cpu").batch_at(0)
    got = psplit(batch, 2)
    want = jsplit(to_jax({k: v.numpy() for k, v in batch.items()}), 2)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the optimizer state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_opt_state_round_trip_and_paths(opt):
    """The reference's state after an update (and an ``ef``) comes across at
    the paths and shapes of the port's own ``init``, float32, and goes
    back bit for bit."""
    _, jp, pm = pair("llama3.2-3b")
    jopt = JO.OPTIMIZERS[opt](lr=1e-2)
    grads = jax.tree.map(lambda p: 0.1 * p, jp)
    _, js = jax.jit(jopt.update)(grads, jopt.init(jp), jp, jnp.int32(0))
    js = dict(js, ef=jax.jit(JC.compress_grads_int8)(grads)[2])
    want = jax.tree.map(np.asarray, js)
    got = convert.lm_opt_state_from_numpy(want, "cpu")
    mine = dict(PO.OPTIMIZERS[opt]().init(pm.params()),
                ef=PC.init_error_feedback(pm.params()))
    assert ({k: (tuple(v.shape), v.dtype) for k, v in flat(got).items()}
            == {k: (tuple(v.shape), v.dtype) for k, v in flat(mine).items()})
    back = flat(convert.lm_opt_state_to_numpy(got))
    for k, a in flat(want).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


# ---------------------------------------------------------------------------
# (vi) + (vii) train() end to end
# ---------------------------------------------------------------------------

def _step_arrays(ckpt: Path, step: int) -> list:
    with np.load(ckpt / f"step_{step:08d}" / "shard0.npz") as data:
        return [data[f"a{i}"] for i in range(len(data.files))]


def test_train_resumes_from_a_reference_checkpoint(tmp_path, capsys):
    """The reference's ``train(steps=0)`` saves step 0; the reference and
    the port each resume from a copy for 6 steps: losses within 1e-4 a
    step.  The port's 3 steps then a resume to 6 equal its uninterrupted 6
    (losses and the saved arrays, bit for bit)."""
    from repro.launch.train import train as jax_train
    from repro_torch.launch.train import train

    kw = dict(smoke=True, batch=2, seq=16, log_every=100)
    jax_train("llama3.2-3b", steps=0, ckpt_dir=str(tmp_path / "ref"), **kw)
    for name in ("jax", "port", "port3"):
        shutil.copytree(tmp_path / "ref", tmp_path / name)
    want = jax_train("llama3.2-3b", steps=6, ckpt_dir=str(tmp_path / "jax"),
                     **kw)
    got = train("llama3.2-3b", steps=6, ckpt_dir=str(tmp_path / "port"),
                device="cpu", **kw)
    assert "[train] resumed from step 0" in capsys.readouterr().out
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               atol=1e-4)
    train("llama3.2-3b", steps=3, ckpt_dir=str(tmp_path / "port3"),
          device="cpu", **kw)
    resumed = train("llama3.2-3b", steps=6, ckpt_dir=str(tmp_path / "port3"),
                    device="cpu", **kw)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert resumed["steps"] == 3 and resumed["losses"] == got["losses"][3:]
    for a, b in zip(_step_arrays(tmp_path / "port3", 6),
                    _step_arrays(tmp_path / "port", 6)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grad_compress", [False, True])
def test_train_driver_learns(grad_compress):
    """The reference's own criteria (``tests/test_system.py``): 25 steps,
    batch 8, 64 positions, lr 1e-3; the loss falls, and with int8
    compression ends within 0.05 of the first."""
    from repro_torch.launch.train import train

    out = train("llama3.2-3b", smoke=True, steps=25, batch=8, seq=64,
                ckpt_dir=None, lr=1e-3, grad_compress=grad_compress,
                log_every=100, device="cpu")
    if grad_compress:
        assert out["final_loss"] < out["first_loss"] + 0.05, out
    else:
        assert out["final_loss"] < out["first_loss"], out


def test_train_cli_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main

    argv = ["--arch", "llama3.2-3b", "--smoke", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--optimizer", "adafactor",
            "--grad-compress", "--ckpt-dir", str(tmp_path)]
    main(argv + ["--steps", "4"])
    assert "[train] done: loss" in capsys.readouterr().out
    main(argv + ["--steps", "6"])
    assert "[train] resumed from step 4" in capsys.readouterr().out


def test_train_lm_torch_example_runs(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--tiny", "--steps", "25", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
    assert "over 25 steps" in capsys.readouterr().out


def test_checkpoint_saves_bfloat16_leaves(tmp_path):
    """A bfloat16 parameter goes to the checkpoint widened exactly to
    float32 (numpy has no bfloat16) and comes back into the parameter's
    dtype through ``copy_``, as ``train()`` restores it."""
    from repro_torch.checkpoint import CheckpointManager

    p = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(1, {"w": p})
    mgr.wait()
    got, extra = mgr.restore({"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert extra["step"] == 1 and got["w"].dtype == torch.float32
    back = torch.zeros(3, 5, dtype=torch.bfloat16).copy_(got["w"])
    assert torch.equal(back, p)
