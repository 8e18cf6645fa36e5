"""The port's production mesh rules (``repro_torch.launch.mesh``) against the
JAX package's (``repro.launch.mesh``), with no process group: the specs
both give every parameter, cache and optimizer-state leaf of all ten
presets at full width (shapes only, nothing allocated), and every input of
every cell, on both production meshes, with FSDP and without.

The reference's ``spec_for`` needs only ``mesh.shape`` (as its own
``tests/test_roofline.py`` uses it); its ``batch_sharding`` gets a
``jax.sharding.AbstractMesh``.  A spec is compared entry by entry with the
reference's ``PartitionSpec``.  Then the DTensor placements a spec maps to,
and the production mesh's refusal of a world of another size.
"""
import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro import optim as JO
from repro.launch import mesh as JM
from repro.models import Model as JaxModel
from repro.models import params as jparams
from repro_torch import configs as pconfigs
from repro_torch import optim as PO
from repro_torch.dist.collectives import Mesh, placements
from repro_torch.launch import mesh as PM
from repro_torch.models import Model
from repro_torch.models.params import axes_tree

MESHES = {"single_pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}


class FakeMesh:
    """What the reference's ``spec_for`` reads of a mesh: its shape."""

    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))


def meshes(which):
    names, sizes = MESHES[which]
    return Mesh(names, sizes), FakeMesh(names, sizes)


def leaves(tree, prefix=""):
    """``{dotted path: leaf}`` of a nested dict (a tuple is a leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def both_rules(arch, fsdp, multi_pod):
    """(reference config, port config, reference rules, port rules)."""
    jcfg = dataclasses.replace(jconfigs.get(arch), fsdp=fsdp)
    pcfg = dataclasses.replace(pconfigs.get(arch), fsdp=fsdp)
    return (jcfg, pcfg, JM.rules_for(jcfg, multi_pod=multi_pod),
            PM.rules_for(pcfg, multi_pod=multi_pod))


def same_specs(pspecs, jspecs, pmesh, jmesh, prules, jrules):
    """Every leaf's spec in both packages, entry by entry; returns the
    number of leaves compared."""
    p, j = leaves(pspecs), leaves(jspecs)
    assert set(p) == set(j)
    for path, js in j.items():
        ps = p[path]
        assert ps.axes == js.axes and ps.shape == js.shape, path
        want = tuple(JM.spec_for(js.axes, js.shape, jmesh, jrules))
        got = PM.spec_for(ps.axes, ps.shape, pmesh, prules)
        assert got == want, (path, got, want)
    return len(j)


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", pconfigs.ARCH_NAMES)
def test_param_and_cache_specs_match_reference(arch, which):
    """Every parameter leaf, and every cache leaf of a 4 x 4128 cache (16
    source frames), with and without FSDP."""
    pmesh, jmesh = meshes(which)
    for fsdp in (False, True):
        jcfg, pcfg, jrules, prules = both_rules(arch, fsdp,
                                                which == "multi_pod")
        assert prules == jrules
        jm, pm = JaxModel(jcfg), Model(pcfg)
        n = same_specs(pm.param_specs(), jm.param_specs(), pmesh, jmesh,
                       prules, jrules)
        n += same_specs(pm.cache_specs(4, 4128, src_len=16),
                        jm.cache_specs(4, 4128, src_len=16), pmesh, jmesh,
                        prules, jrules)
        assert n > 10


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", pconfigs.ARCH_NAMES)
def test_optimizer_state_specs_match_reference(arch, opt, which):
    """Every ``state_axes`` leaf at its shape (the port's ``init`` on meta
    parameters, the reference's under ``jax.eval_shape``)."""
    pmesh, jmesh = meshes(which)
    for fsdp in (False, True):
        jcfg, pcfg, jrules, prules = both_rules(arch, fsdp,
                                                which == "multi_pod")
        jm, pm = JaxModel(jcfg), Model(pcfg)
        jopt, popt = JO.OPTIMIZERS[opt](), PO.OPTIMIZERS[opt]()
        jshapes = leaves(jax.eval_shape(jopt.init, jm.abstract()))
        jaxes = leaves(jopt.state_axes(jparams.axes_tree(jm.param_specs())))
        pshapes = leaves(popt.init(pm.abstract()))
        paxes = leaves(popt.state_axes(axes_tree(pm.param_specs())))
        assert set(pshapes) == set(jshapes) == set(paxes) == set(jaxes)
        for path, js in jshapes.items():
            assert tuple(pshapes[path].shape) == tuple(js.shape), path
            assert paxes[path] == jaxes[path], path
            want = tuple(JM.spec_for(jaxes[path], js.shape, jmesh, jrules))
            got = PM.spec_for(paxes[path], tuple(js.shape), pmesh, prules)
            assert got == want, (path, got, want)


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", pconfigs.ARCH_NAMES)
def test_batch_sharding_matches_reference(arch, which):
    """Every input of every cell (``batch_shapes``), and shapes that do not
    divide the batch axes."""
    names, sizes = MESHES[which]
    pmesh = Mesh(names, sizes)
    jmesh = jax.sharding.AbstractMesh(sizes, names)
    for fsdp in (False, True):
        jcfg, pcfg, jrules, prules = both_rules(arch, fsdp,
                                                which == "multi_pod")
        n = 0
        for shape_name in jconfigs.SHAPES:
            jb = jconfigs.batch_shapes(jcfg, jconfigs.SHAPES[shape_name])
            pb = pconfigs.batch_shapes(pcfg, pconfigs.SHAPES[shape_name])
            assert set(jb) == set(pb)
            for key, (shape, _, kind) in jb.items():
                assert tuple(pb[key][0]) == tuple(shape) and \
                    pb[key][2] == kind, key
                for sh in (tuple(shape), (3,) * len(shape)):
                    want = tuple(JM.batch_sharding(jmesh, jrules, kind,
                                                   sh).spec)
                    got = PM.batch_sharding(pmesh, prules, kind, sh).spec
                    assert got == want, (shape_name, key, sh, got, want)
                    n += 1
        assert n > 0


def test_spec_for_guards_as_the_reference():
    """The divisibility guard, no mesh axis for two dims, the trailing-None
    trim, ``allow_uneven`` and a tuple rule (the reference's own cases
    and more)."""
    shape = {"data": 4, "model": 4}
    pmesh, jmesh = Mesh(tuple(shape), tuple(shape.values())), \
        FakeMesh(tuple(shape), tuple(shape.values()))
    cases = [
        (("a", "b"), (16, 16), {"a": "model", "b": "model"}, False),
        (("a", "b"), (6, 16), {"a": "model", "b": "model"}, False),
        (("a", "b"), (6, 16), {"a": "model", "b": "model"}, True),
        (("a", None, "b"), (16, 3, 8), {"a": ("data", "model"),
                                        "b": "model"}, False),
        (("a", "b", "c"), (8, 8, 3), {"a": None, "b": "data",
                                      "c": "model"}, False),
        ((None, None), (4, 4), {}, False),
    ]
    for axes, shp, rules, uneven in cases:
        want = tuple(JM.spec_for(axes, shp, jmesh, rules,
                                 allow_uneven=uneven))
        assert PM.spec_for(axes, shp, pmesh, rules,
                           allow_uneven=uneven) == want, (axes, shp)
    assert PM.BASE_RULES == JM.BASE_RULES
    assert PM.rules_for(None, overrides={"flash_q": "model"}) == \
        JM.rules_for(None, overrides={"flash_q": "model"})


def test_placements_of_a_spec():
    """A spec's DTensor placements: ``Shard(d)`` on each mesh axis its dim
    names, in mesh order (pod-major for ``("pod", "data")``),
    ``Replicate()`` elsewhere; another order or an axis used twice
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = Mesh(("pod", "data", "model"), (2, 16, 16))
    assert placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(mesh, ()) == (Replicate(),) * 3
    assert placements(mesh, (None, "data")) == (Replicate(), Shard(1),
                                                Replicate())
    with pytest.raises(ValueError, match="order"):
        placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="twice"):
        placements(mesh, ("model", "model"))
    sh = PM.sharding_fn(mesh, PM.rules_for(None))(("vocab", "embed"),
                                                  (256000, 3072))
    assert sh.spec == ("model",)
    assert sh.placements == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="DeviceMesh"):
        sh.device_mesh


@pytest.mark.parametrize("multi_pod,ranks", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_world(multi_pod, ranks):
    """With no process group, ``make_mesh`` asks for one; on a one-rank
    group the grid's size is named."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        PM.make_production_mesh(multi_pod=multi_pod)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match=f"{ranks} ranks"):
            PM.make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()


def test_launch_exports_what_the_reference_does():
    import repro.launch as jlaunch
    import repro_torch.launch as plaunch

    assert set(jlaunch.__all__) <= set(plaunch.__all__)
    for name in jlaunch.__all__:
        assert callable(getattr(plaunch, name))
    assert torch.distributed.is_available()
