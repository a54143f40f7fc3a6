"""The port's layout rules (``repro_torch.sharding.partition``,
``repro_torch.launch.input_specs``) against the JAX package's, at the
published widths of all ten archs on both production meshes.

Both packages' trees are shapes only: the reference's from
``jax.eval_shape`` over its ``init_lm`` / ``init_cache`` with the stand-in mesh of ``tests/test_sharding.py``
(names and shape, no devices), the port's from ``FakeTensorMode``. A
port parameter's spec is held to its reference leaf's (found by
``reference_leaf_path``) less the leaf's leading stack axes, exactly.
The reference's ``input_specs`` wraps each spec in a ``NamedSharding``,
which needs real devices; the tests read the specs by replacing that
name in the reference module with the spec itself.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.launch import input_specs as jis
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_lm as jinit_lm
from repro.sharding.partition import Partitioner as JPartitioner
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, cell_is_applicable,
                                 get_config, get_shape)
from repro_torch.launch import input_specs as tis
from repro_torch.models.model import reference_leaf_path
from repro_torch.roofline import hw
from repro_torch.sharding.partition import (Partitioner, local_shape,
                                            placements, shard_bytes)

torch.set_num_threads(1)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """Stand-in mesh (names and shape; both packages' rules read only
    those)."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _norm(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda k: jinit_lm(k, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tis.param_structs(get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape_name):
    jcfg, jshape = jget_config(arch), jget_shape(shape_name)
    return jax.eval_shape(functools.partial(
        jinit_cache, jcfg, jshape.global_batch, jshape.seq_len))


@functools.lru_cache(maxsize=None)
def _port_cache(arch, shape_name):
    shape = get_shape(shape_name)
    return tis.cache_structs(get_config(arch), shape.global_batch,
                             shape.seq_len)


@functools.lru_cache(maxsize=None)
def _port_opt(arch):
    return tis.opt_structs(get_config(arch))


def _ref_partitioner(cfg, mesh, names):
    if cfg.sharding_policy == "fsdp":
        return JPartitioner(mesh, fsdp_axes=names, tp_axis="__none__")
    return JPartitioner(mesh)


def _at(tree, keys, idx=()):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch, mesh_kind):
    shape, names = MESHES[mesh_kind]
    mesh = FakeMesh(shape, names)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jspecs = _ref_partitioner(jcfg, mesh, names).specs(_ref_params(arch))
    port = tis.make_partitioner(mesh, cfg)
    params = _port_params(arch)
    specs = port.specs(((n, p.shape) for n, p in params.items()), cfg)
    sizes = dict(zip(names, shape))
    n_sharded = 0
    for name, p in params.items():
        keys, idx = reference_leaf_path(cfg, name)
        want = tuple(_at(jspecs, keys))
        leaf = _at(_ref_params(arch), keys)
        assert tuple(leaf.shape[len(idx):]) == tuple(p.shape), name
        assert _norm(specs[name]) == _norm(want[len(idx):]), \
            (name, specs[name], want)
        # the reference's test_specs_divisible, on the port's parameter
        for dim, ax in zip(p.shape, specs[name]):
            if ax is None:
                continue
            n_sharded += 1
            total = int(np.prod([sizes[a] for a in
                                 ((ax,) if isinstance(ax, str) else ax)]))
            assert dim % total == 0, (name, p.shape, specs[name])
    assert n_sharded > 0


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(mesh, (None, None)) == (Replicate(),) * 3
    assert local_shape((64, 8, 32), (("pod", "data"), None, "model"),
                       {"pod": 2, "data": 16, "model": 16}) == (2, 8, 2)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "mixtral-8x22b",
                                  "mistral-nemo-12b"])
def test_big_models_bytes_match_reference(arch):
    """Per-device parameter bytes on the multi-pod mesh, to the byte, as
    the reference's test_big_models_fit_hbm counts them; with the
    optimizer's multiplier they fit the H100's 80 GB."""
    shape, names = MESHES["multipod"]
    mesh = FakeMesh(shape, names)
    sizes = dict(zip(names, shape))
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams = _ref_params(arch)
    jspecs = JPartitioner(mesh).specs(jparams)

    def ref_bytes(leaf, spec):
        n = leaf.size * leaf.dtype.itemsize
        for dim, ax in zip(leaf.shape, tuple(spec)):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            n //= int(np.prod([sizes[a] for a in axes]))
        return n

    want = sum(ref_bytes(l, s) for l, s in zip(
        jax.tree.leaves(jparams),
        jax.tree.leaves(jspecs, is_leaf=lambda s: isinstance(s, P))))
    params = _port_params(arch)
    specs = Partitioner(mesh).specs(
        ((n, p.shape) for n, p in params.items()), cfg)
    got = sum(shard_bytes(p.shape, p.element_size(), specs[n], sizes)
              for n, p in params.items())
    assert got == want
    opt_mult = {"adamw": 1 + 4.0, "adafactor": 1 + 0.1}[cfg.optimizer]
    share = got * opt_mult / hw.HBM_BYTES
    print(f"{arch}: {got} B of parameters a device, "
          f"{share:.4f} of the H100's 80 GB with the optimizer")
    assert share < 1.0


@pytest.fixture
def ref_specs_only(monkeypatch):
    """The reference's input_specs with NamedSharding(mesh, s) -> s."""
    monkeypatch.setattr(jis, "NamedSharding", lambda mesh, spec: spec)


def _cells():
    for mesh_kind in sorted(MESHES):
        for arch in ASSIGNED_ARCHS:
            for shape_name in SHAPES:
                if cell_is_applicable(get_config(arch), get_shape(shape_name)):
                    yield arch, shape_name, mesh_kind


def _flat_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P) and \
            (not tree or not isinstance(tree[0], (str, type(None), tuple))
             or isinstance(tree[0], dict)):
        for i, v in enumerate(tree):
            yield from _flat_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,shape_name,mesh_kind", list(_cells()))
def test_input_specs_match_reference(arch, shape_name, mesh_kind,
                                     ref_specs_only):
    """Batch, cache and optimizer specs of every applicable cell."""
    shape, names = MESHES[mesh_kind]
    mesh = FakeMesh(shape, names)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshape, tshape = jget_shape(shape_name), get_shape(shape_name)
    jpart = jis.make_partitioner(mesh, jcfg)
    tpart = tis.make_partitioner(mesh, cfg)

    jb = jis.batch_shardings(mesh, jpart, jcfg,
                             jis.batch_structs(jcfg, jshape))
    tb = tis.batch_shardings(mesh, tpart, tis.batch_structs(cfg, tshape))
    assert set(jb) == set(tb)
    for key in jb:
        assert _norm(tb[key]) == _norm(tuple(jb[key])), key

    if tshape.kind == "decode":
        jc = jis.cache_shardings(mesh, jpart, jcfg,
                                 _ref_cache(arch, shape_name))
        tc = tis.cache_shardings(mesh, tpart, _port_cache(arch, shape_name))
        jflat = jax.tree_util.tree_flatten_with_path(
            jc, is_leaf=lambda s: isinstance(s, P))[0]
        tflat = dict(_flat_with_paths(tc))
        assert len(jflat) == len(tflat)
        for path, spec in jflat:
            key = tuple(getattr(e, "key", getattr(e, "idx", None))
                        for e in path)
            assert _norm(tflat[key]) == _norm(tuple(spec)), key

    if tshape.kind == "train":
        jparams = _ref_params(arch)
        jp_specs = jpart.specs(jparams)
        jo = jis.opt_shardings(mesh, jp_specs, jparams, jcfg.optimizer)
        tparams, tstate = _port_opt(arch)
        tp_specs = tpart.specs(((n, p.shape) for n, p in tparams.items()),
                               cfg)
        to = tis.opt_shardings(tp_specs, tstate)
        for name in tparams:
            keys, idx = reference_leaf_path(cfg, name)
            if cfg.optimizer == "adamw":
                for mom in ("m", "v"):
                    want = tuple(_at(jo[mom], keys))
                    assert _norm(to[mom][name]) == _norm(want[len(idx):])
            else:
                want = _at(jo["v"], keys)
                got = to["v"][name]
                assert set(got) == set(want), name
                for part, spec in want.items():
                    w = tuple(spec)
                    # the stack axes lead every factored leaf's spec
                    assert _norm(got[part]) == _norm(w[len(idx):]), \
                        (name, part)
