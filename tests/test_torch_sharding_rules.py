"""The port's sharding rules (`repro_torch.sharding.rules`) held against the
reference's `repro.sharding.rules` on the CPU.

The rules are pure functions of a mesh shape, so both sides are evaluated
at the production meshes (16, 16) and (2, 16, 16) and at (4, 2) and
(1, 1) without a device: the reference on `jax.sharding.AbstractMesh`,
the port on `MeshShape`. For every registered arch at full size (the
reference's params from `jax.eval_shape`, the port's on the meta device)
`param_specs` (also with the bank axis), `batch_specs` (plain and
microbatch-major) and `cache_specs` equal the reference's entry for entry,
and every sharded axis divides its dim: the counterpart of the reference's
test_substrate.py::test_param_specs_divisibility, whose helper builds its
AbstractMesh in a form jax 0.9 refuses. The flat-engine rules
(`flat_axes`, `flat_bank_spec`, `flat_theta_spec`, `flat_shardings`,
`paged_shardings`) equal the reference's on the cases of
tests/test_sharded_engine.py and on owner and parameter counts that do
not divide.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
import repro.sharding.rules as jrules
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.launch import specs as tspecs
from repro_torch.models import LM
from repro_torch.sharding import rules
from repro_torch.tree_util import tree_flatten, tree_map

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = sorted(tconfigs.all_configs())


def _meshes(name):
    shape, names = MESHES[name]
    return rules.MeshShape(shape, names), AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    return cfg, jcfg, LM(cfg), jax_build_model(jcfg, remat=False)


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg, jcfg, lm, jlm = _models(arch)
    return tspecs.params_specs(lm), jspecs.params_specs(jlm)


def _specs(tree):
    """The spec leaves of a port spec tree, in jax's leaf order."""
    leaves = []

    def walk(x):
        if isinstance(x, rules.PartitionSpec):
            leaves.append(tuple(x))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return leaves


def _jspecs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg, jcfg, _, _ = _models(arch)
    tparams, jparams = _params(arch)
    tmesh, jmesh = _meshes(mesh)
    got = _specs(rules.param_specs(tparams, cfg, tmesh))
    want = _jspecs(jrules.param_specs(jparams, jcfg, jmesh))
    assert len(got) == len(tree_flatten(tparams)[0])
    assert got == want
    # the owner bank: every leaf with a leading (N,) owner axis
    tbank = tree_map(lambda t: torch.empty((16,) + tuple(t.shape), device="meta"), tparams)
    jbank = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct((16,) + tuple(t.shape), t.dtype), jparams)
    assert (_specs(rules.param_specs(tbank, cfg, tmesh, bank_axis=True))
            == _jspecs(jrules.param_specs(jbank, jcfg, jmesh, bank_axis=True)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    cfg, jcfg, lm, jlm = _models(arch)
    tmesh, jmesh = _meshes(mesh)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape = tconfigs.get_shape(name)
        jshape = jconfigs.ShapeConfig(**dataclasses.asdict(shape))
        for mb in (0, 8):
            if mb and shape.global_batch % mb:
                continue
            tb = tspecs.train_batch_specs(cfg, shape, microbatches=mb)
            jb = jspecs.train_batch_specs(jcfg, jshape, microbatches=mb)
            assert (_specs(rules.batch_specs(tb, shape, tmesh, microbatches=mb))
                    == _jspecs(jrules.batch_specs(jb, jshape, jmesh, microbatches=mb)))
        if shape.kind == "decode" or name == "long_500k":
            got = rules.cache_specs(tspecs.cache_specs_struct(lm, shape), cfg, tmesh,
                                    shape.global_batch)
            want = jrules.cache_specs(jspecs.cache_specs_struct(jlm, jshape), jcfg, jmesh,
                                      jshape.global_batch)
            assert _specs(got) == _jspecs(want)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisibility(arch, mesh):
    """Every sharded axis divides its dim on the production meshes."""
    cfg, _, _, _ = _models(arch)
    tparams, _ = _params(arch)
    tmesh, _ = _meshes(mesh)
    specs = _specs(rules.param_specs(tparams, cfg, tmesh))
    leaves = tree_flatten(tparams)[0]
    sharded = 0
    for leaf, spec in zip(leaves, specs):
        assert len(spec) <= len(leaf.shape), (spec, leaf.shape)
        for dim, ax in zip(leaf.shape, spec):
            if ax is None:
                continue
            size = rules.axis_size(tmesh, ax)
            assert dim % size == 0, (spec, leaf.shape)
            sharded += 1
    assert sharded > 0


FLAT_CASES = [((4, 2), 8, 64), ((4, 2), 3, 64), ((4, 2), 3, 7), ((4, 2), 8, 7),
              ((4, 2), 6, 64), ((2, 2), 3, 28), ((4, 1), 3, 28), ((1, 4), 3, 28),
              ((1, 4), 8, 30), ((16, 16), 16, 152_783_616), ((16, 16), 3, 152_783_616),
              ((1, 1), 8, 28)]


@pytest.mark.parametrize("shape,n,p", FLAT_CASES)
def test_flat_rules_equal_the_reference(shape, n, p):
    tmesh = rules.MeshShape(shape, ("data", "model"))
    jmesh = AbstractMesh(shape, ("data", "model"))
    assert rules.flat_axes(tmesh, n, p) == jrules.flat_axes(jmesh, n, p)
    assert tuple(rules.flat_bank_spec(tmesh, n, p)) == tuple(jrules.flat_bank_spec(jmesh, n, p))
    assert tuple(rules.flat_theta_spec(tmesh, n, p)) == tuple(
        jrules.flat_theta_spec(jmesh, n, p))
    for build in ("flat_shardings", "paged_shardings"):
        got = getattr(rules, build)(tmesh, n, p)
        # the reference's NamedSharding needs a concrete mesh: compare the
        # specs its bundle is built from
        n_ax, p_ax = jrules.flat_axes(jmesh, n, p)
        P = jax.sharding.PartitionSpec
        want = dict(theta=P(p_ax), bank=P(n_ax, p_ax), row=P(p_ax), ledger=P(),
                    bank_scales=P(n_ax), tree_nodes=P(n_ax, None, p_ax), faults=P())
        for field, spec in want.items():
            assert tuple(getattr(got, field).spec) == tuple(spec), field
            assert getattr(got, field).mesh is tmesh


def test_flat_axes_cases_of_the_reference():
    mesh = rules.MeshShape((4, 2), ("data", "model"))
    assert rules.flat_axes(mesh, n_owners=8, p=64) == (("data",), ("model",))
    assert rules.flat_bank_spec(mesh, 8, 64) == rules.P(("data",), ("model",))
    assert rules.flat_axes(mesh, n_owners=3, p=64) == (None, ("model", "data"))
    assert rules.flat_axes(mesh, n_owners=3, p=7) == (None, None)
    pod = rules.MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert rules.flat_axes(pod, n_owners=8, p=64) == (("pod", "data"), ("model",))
    assert rules.data_axes(pod) == ("pod", "data") and rules.data_axes(mesh) == ("data",)
    assert rules.axis_size(pod, ("pod", "data")) == 4 and rules.axis_size(mesh, "pod") == 1


def test_partition_spec_and_named():
    P = rules.PartitionSpec
    assert P(("data",), None) == ("data", None) == tuple(jax.sharding.PartitionSpec(
        ("data",), None))
    assert P(("model", "data")) == (("model", "data"),)
    mesh = rules.MeshShape((1, 1), ("data", "model"))
    tree = {"a": P("data"), "b": [P(), P(None, "model")]}
    named = rules.named(mesh, tree)
    assert named["a"] == rules.NamedSharding(mesh, P("data"))
    assert named["b"][1].spec == P(None, "model") and named["b"][1].mesh is mesh
    assert rules.mesh_shape(AbstractMesh((4, 2), ("data", "model"))) == rules.MeshShape(
        (4, 2), ("data", "model"))
    with pytest.raises(TypeError, match="not a mesh"):
        rules.mesh_shape(object())
    np.testing.assert_equal(rules.MeshShape((2, 3), ("a", "b")).size, 6)
