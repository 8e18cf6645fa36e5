"""The port's launch layer, ``repro_torch.launch``, against the JAX package's
``repro.launch``.

LM serving: the reference's ``make_prefill_step``/``make_serve_step`` greedy
loop and the port's ``generate`` over the same smoke parameters give the
same tokens, and logits within 1e-4, in float32 on the CPU; each of the six
other families' ``serve`` gives the reference ``serve``'s tokens.  Decomposition
serving: ``cpd_config`` gives the reference's RunConfig, key for key, and
``serve_cpd`` equals a Session on that config.  No model here is wider than
``smoke_of``; entry points are asked for the CPU by name, and raise without
a card when they are not.
"""
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_workspace as jax_build_workspace
from repro.launch import serve as jserve
from repro.launch.steps import make_cpals_step as jax_make_cpals_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.plan import plan_decomposition as jax_plan
from repro_torch import convert
from repro_torch.api import Session
from repro_torch.core import build_workspace
from repro_torch.core.cpals import _iteration
from repro_torch.launch import serve as pserve
from repro_torch.launch.steps import make_cpals_step
from repro_torch.models import Model
from repro_torch.plan import plan_decomposition

from test_torch_helpers import (both_tensors, lm_cfgs, lm_pair, np_coo,
                                np_factors, np_params)

ROOT = Path(__file__).resolve().parents[1]
SMOKE_MODELS = {
    "llama": ("llama3.2-3b", {}),
    "gemma": ("gemma-7b", {}),
    "local": ("llama3.2-3b", dict(name="llama3.2-3b-local-smoke",
                                  attn_kind="local", window=8)),
}


def _jax_greedy(jm, jp, prompts, gen):
    """The reference's serve loop (``repro.launch.serve.serve``) on given
    parameters: tokens (B, gen) and each step's logits (B, gen, V)."""
    b, s = prompts.shape
    cache = jm.init_cache(b, s + gen)
    logits, cache = jax_make_prefill_step(jm)(
        jp, {"tokens": jnp.asarray(prompts)}, cache)
    step = jax_make_serve_step(jm)
    toks = [jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)]
    steps = [logits[:, -1]]
    for i in range(gen - 1):
        logits, cache = step(jp, toks[-1][:, None], cache,
                             jnp.array(s + i, dtype=jnp.int32))
        steps.append(logits[:, -1])
        toks.append(jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32))
    return np.asarray(jnp.stack(toks, 1)), np.asarray(jnp.stack(steps, 1))


@pytest.mark.parametrize("name", list(SMOKE_MODELS))
def test_greedy_loop_matches_reference(name):
    """Prompt 10, 6 generated tokens (the local model's 8-slot ring wraps):
    equal tokens, logits within 1e-4."""
    arch, over = SMOKE_MODELS[name]
    jm, jp, pm = lm_pair(arch, seed=1, **over)
    prompts = np.random.default_rng(0).integers(0, 512, (3, 10)).astype(
        np.int32)
    want_toks, want_logits = _jax_greedy(jm, jp, prompts, 6)
    out = pserve.generate(pm, {"tokens": torch.as_tensor(prompts)}, gen=6)
    np.testing.assert_array_equal(out["tokens"], want_toks)
    np.testing.assert_allclose(out["logits"].numpy(), want_logits,
                               rtol=1e-4, atol=1e-4)
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    assert out["decode_tok_s"] == pytest.approx(3 * 5 / out["decode_s"])


def test_serve_draws_the_reference_prompts_on_the_cpu():
    """``serve`` = a model drawn from ``seed`` on the device + the
    reference's numpy prompts + ``generate``."""
    out = pserve.serve("llama3.2-3b", smoke=True, batch=2, prompt_len=8,
                       gen=4, seed=5, device="cpu")
    _, cfg = lm_cfgs("llama3.2-3b")
    model = Model(cfg).init(torch.Generator().manual_seed(5), "cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 8),
                                                dtype=np.int32)
    again = pserve.generate(model, {"tokens": torch.as_tensor(prompts)},
                            gen=4)
    assert out["tokens"].shape == (2, 4) and out["tokens"].dtype == np.int32
    assert out["logits"].shape == (2, 4, cfg.vocab)
    assert torch.isfinite(out["logits"]).all()
    np.testing.assert_array_equal(out["tokens"], again["tokens"])
    assert torch.equal(out["logits"], again["logits"])


FAMILIES = ("rwkv6-3b", "recurrentgemma-9b", "qwen2-vl-7b",
            "seamless-m4t-large-v2", "dbrx-132b", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_matches_reference_serve(arch, monkeypatch):
    """``serve`` of each family's smoke model in both packages, batch 2,
    prompt 10, 5 tokens: each package's own prompts, embeddings, M-RoPE
    positions and source frames from the seed, the same numpy-drawn
    parameters handed to both (each launcher's model class made to load
    them), the same greedy tokens."""
    _, pcfg = lm_cfgs(arch)
    tree = np_params(Model(pcfg).param_specs(), 1)

    class RefModel(jserve.Model):
        def init(self, key):
            return jax.tree.map(jnp.asarray, tree)

    class PortModel(Model):
        def init(self, generator=None, device=None):
            self.load_state_dict(convert.lm_params_from_numpy(
                self.cfg, tree, device), assign=True)
            return self

    monkeypatch.setattr(jserve, "Model", RefModel)
    monkeypatch.setattr(pserve, "Model", PortModel)
    kw = dict(smoke=True, batch=2, prompt_len=10, gen=5, seed=2)
    want = jserve.serve(arch, **kw)
    got = pserve.serve(arch, device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["logits"].shape == (2, 5, pcfg.vocab)
    assert torch.isfinite(got["logits"]).all()
    assert set(got["metrics"]) == (
        {"moe_drop_frac", "moe_balance_loss"} if pcfg.moe else set())


def test_serve_batch_builds_the_reference_inputs():
    """``serve_batch``: embeddings through the table, M-RoPE positions
    0..S-1 on all three streams, 16 source frames drawn after the
    prompts."""
    for arch in ("qwen2-vl-7b", "seamless-m4t-large-v2"):
        _, cfg = lm_cfgs(arch)
        model = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(4)
        prompts = rng.integers(0, cfg.vocab, (3, 7), dtype=np.int32)
        batch = pserve.serve_batch(model, prompts, rng)
        again = np.random.default_rng(4)
        again.integers(0, cfg.vocab, (3, 7), dtype=np.int32)
        if cfg.input_mode == "embeds":
            assert set(batch) == {"embeds", "positions"}
            assert torch.equal(batch["embeds"],
                               model.embed.table[torch.as_tensor(prompts)
                                                 .long()])
            assert torch.equal(batch["positions"][2, 1],
                               torch.arange(7, dtype=torch.int32))
            assert batch["positions"].shape == (3, 3, 7)
        else:
            assert set(batch) == {"tokens", "src_embeds"}
            assert batch["src_embeds"].shape == (3, pserve.SRC_LEN, 64)
            np.testing.assert_array_equal(
                batch["src_embeds"].numpy(),
                again.standard_normal((3, 16, 64), dtype=np.float32))


def test_serve_refuses_what_it_cannot_run(monkeypatch):
    # no card: the default device raises, it never carries on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.serve("llama3.2-3b", smoke=True, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.serve_cpd("cpals-yelp", smoke=True, batch=8, queries=16,
                         rank=2, niters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(lm_cfgs("llama3.2-3b")[1]).init()


@pytest.mark.parametrize("workload", ["cpals-yelp", "cpals-nell2",
                                      "cpals-netflix"])
@pytest.mark.parametrize("method", ["cp_als", "cp_nn_hals", "tucker_hooi",
                                    "cp_als_streaming"])
def test_cpd_config_matches_reference(workload, method):
    smoke = method != "tucker_hooi"
    kw = dict(smoke=smoke, rank=7, niters=3, policy="segment", seed=2,
              reorder="degree_sort", cache="/data/cache", method=method)
    assert (pserve.cpd_config(workload, **kw).to_dict()
            == jserve.cpd_config(workload, **kw).to_dict())


def test_cpd_config_refuses_an_unknown_method():
    kw = dict(smoke=True, rank=4, niters=2, policy="auto", seed=0,
              reorder="identity", cache=None, method="svd")
    with pytest.raises(ValueError, match="unknown method"):
        jserve.cpd_config("cpals-yelp", **kw)
    with pytest.raises(ValueError, match="unknown method"):
        pserve.cpd_config("cpals-yelp", **kw)


def test_serve_cpd_equals_a_session_and_warms_its_cache(tmp_path, capsys):
    """Rank 4, 2 iterations on the smoke yelp replica: the fit and plan of
    a Session on ``cpd_config``; a relaunch on the same cache hits it and
    fits the same."""
    kw = dict(smoke=True, batch=64, queries=256, rank=4, niters=2,
              policy="segment", cache=str(tmp_path), device="cpu")
    cold = pserve.serve_cpd("cpals-yelp", **kw)
    assert "| mode |" in capsys.readouterr().out  # the plan report
    cfg = pserve.cpd_config("cpals-yelp", smoke=True, rank=4, niters=2,
                            policy="segment", seed=0, reorder="identity",
                            cache=None, method="cp_als")
    with Session(cfg, device="cpu") as sess:
        want = sess.fit()
        plan = sess.plan().summary()
    assert cold["fit"] == float(want.fit) and cold["plan"] == plan
    for a, b in zip(cold["decomp"].factors, want.factors):
        assert torch.equal(a, b)
    assert not cold["cache_hit"] and cold["method"] == "cp_als"
    assert cold["qps"] > 0 and set(cold["latency_ms"]) >= {"p50", "p99"}
    warm = pserve.serve_cpd("cpals-yelp", **kw)
    assert warm["cache_hit"] and warm["fit"] == cold["fit"]


def test_make_cpals_step_matches_reference():
    """One step under the ``segment`` plan from the same factors, both
    packages; and the step is the port's ``_iteration``."""
    dims = (12, 9, 7)
    inds, vals = np_coo(dims, 300, 4)
    jt, pt = both_tensors(inds, vals, dims)
    f = np_factors(dims, 5, 6)
    jplan, pplan = jax_plan(jt, "segment", rank=5), plan_decomposition(
        pt, "segment", rank=5)
    jf = tuple(jnp.asarray(a) for a in f)
    pf = tuple(torch.as_tensor(a) for a in f)
    jout = jax_make_cpals_step(jplan)(
        jax_build_workspace(jt, jplan), jf, tuple(a.T @ a for a in jf),
        jnp.sum(jt.vals ** 2))
    ws = build_workspace(pt, pplan)
    grams = tuple(a.T @ a for a in pf)
    nx = (pt.vals ** 2).sum()
    pout = make_cpals_step(pplan)(ws, pf, grams, nx)
    for got, want in zip(pout[0] + pout[1] + pout[2:],
                         jout[0] + jout[1] + tuple(jout[2:])):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    direct = _iteration(ws, pf, grams, nx, impls=pplan.impls, norm_kind="2")
    assert all(torch.equal(a, b) for a, b in zip(pout[0], direct[0]))


def test_main_serves_both_paths(capsys):
    pserve.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "2",
                 "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] prefill" in out and "tok/s" in out
    pserve.main(["--arch", "cpals-yelp", "--smoke", "--batch", "64",
                 "--queries", "128", "--rank", "3", "--iters", "1",
                 "--impl", "segment", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] method cp_als  plan m0:segment" in out and "p99" in out


def test_serve_lm_torch_example_runs(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_lm_torch.py", "--batch", "2", "--prompt-len", "6", "--gen",
        "3", "--device", "cpu"])
    runpy.run_path(str(ROOT / "examples" / "serve_lm_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b" in out and "request 1: generated" in out
