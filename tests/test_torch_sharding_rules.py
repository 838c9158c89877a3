"""The port's IALS partition rules (``repro_torch/distributed/sharding.py``)
against the reference's (``repro/distributed/sharding.py``), called on the
same duck-typed meshes and the same leaf shapes: the engine's state, its
T-stacked noise stream and Gumbel stream, and the stacked AIP weights of
both domains and both backbones, as ``tests/test_sharding.py`` builds
them. A spec of the port is ``tuple(P(...))`` of the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import sharding as ref_shd
from repro_torch import stream
from repro_torch.core import engine, influence
from repro_torch.distributed import sharding as shd
from repro_torch.envs.api import horizon_noise
from repro_torch.envs.traffic import (TrafficConfig,
                                      make_batched_local_traffic_env)
from repro_torch.envs.warehouse import (WarehouseConfig,
                                        make_batched_local_warehouse_env)
from repro_torch.tree import tree_leaves, tree_leaves_with_path

B = 16


class _HostMesh:
    """Duck-typed host mesh (the reference tests' own): (data, model)."""
    axis_names = ("data", "model")

    def __init__(self, data, model=1):
        self.shape = {"data": data, "model": model}


class _TorchLikeMesh:
    """What a ``DeviceMesh`` shows the rules: ``mesh_dim_names`` and a
    tuple ``shape``."""
    mesh_dim_names = ("data", "model")

    def __init__(self, data, model=1):
        self.shape = (data, model)


MESHES = [(1, 1), (2, 1), (1, 2), (4, 2), (8, 1)]


def _trees(domain, kind, A):
    """The engine's state, a 2-tick noise stream, a Gumbel stream and the
    AIP weights at B = 16 lanes, on the CPU."""
    dev = torch.device("cpu")
    ls = (make_batched_local_traffic_env(TrafficConfig(), dev)
          if domain == "traffic"
          else make_batched_local_warehouse_env(WarehouseConfig(), dev))
    acfg = influence.AIPConfig(kind=kind, d_in=ls.spec.dset_dim,
                               n_out=ls.spec.n_influence, hidden=64,
                               stack=8 if kind == "fnn" else 1)
    g = stream(dev, 0, 0)
    aip = (influence.init_aip_stacked(acfg, g, A, dev) if A > 1
           else influence.init_aip(acfg, g, dev))
    env = engine.make_unified_ials(ls, aip, acfg, n_agents=A)
    state = env.reset(g, B)
    noise = horizon_noise(env.noise_fn, g, 2, B)
    gum = torch.zeros((2, B) + ((A,) if A > 1 else ()) + (3,))
    return state, {"noise": noise, "gumbel": gum}, aip


def _abstract(leaf):
    return jax.ShapeDtypeStruct(tuple(leaf.shape), jnp.float32)


CASES = [(d, k, a) for d in ("traffic", "warehouse") for k in ("fnn", "gru")
         for a in (1, 4, 25, 36)]


@pytest.mark.parametrize("domain,kind,A", CASES,
                         ids=[f"{d}-{k}-A{a}" for d, k, a in CASES])
def test_ials_rules_equal_the_reference(domain, kind, A):
    state, streams, aip = _trees(domain, kind, A)
    for data, model in MESHES:
        ref_mesh = _HostMesh(data, model)
        for mesh in (ref_mesh, _TorchLikeMesh(data, model)):
            ctx = (domain, kind, A, data, model, type(mesh).__name__)
            assert shd.mesh_size(mesh) == ref_shd.mesh_size(ref_mesh)
            assert shd.ials_lane_axes(B, A, mesh) == \
                ref_shd.ials_lane_axes(B, A, ref_mesh), ctx
            for path, leaf in tree_leaves_with_path(state):
                assert shd.ials_state_pspec(leaf, mesh, A) == tuple(
                    ref_shd.ials_state_pspec(_abstract(leaf), ref_mesh, A)
                ), (ctx, path)
            for path, leaf in tree_leaves_with_path(streams):
                assert shd.ials_stream_pspec(leaf, mesh, B, A) == tuple(
                    ref_shd.ials_stream_pspec(_abstract(leaf), ref_mesh, B,
                                              A)), (ctx, path)
            ref_aip = jax.tree_util.tree_leaves(
                ref_shd.ials_aip_param_specs(
                    jax.tree_util.tree_map(_abstract, _numpy(aip)),
                    ref_mesh, A, B),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            port_aip = shd.spec_leaves(
                shd.ials_aip_param_specs(aip, mesh, A, B), aip)
            assert port_aip == [tuple(s) for s in ref_aip], ctx
            # the *_specs trees read back leaf by leaf
            assert shd.spec_leaves(shd.ials_state_specs(state, mesh, A),
                                   state) == [
                shd.ials_state_pspec(l, mesh, A)
                for l in tree_leaves(state)]


def _numpy(tree):
    """A torch pytree as numpy (dict keys sorted, as both packages
    order them)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("domain,kind,A", CASES,
                         ids=[f"{d}-{k}-A{a}" for d, k, a in CASES])
def test_ials_specs_divide_or_replicate(domain, kind, A):
    """Every spec divides its dim on every mesh (or replicates it)."""
    state, streams, aip = _trees(domain, kind, A)
    for data, model in MESHES:
        mesh = _HostMesh(data, model)
        pairs = ([(l, shd.ials_state_pspec(l, mesh, A))
                  for l in tree_leaves(state)]
                 + [(l, shd.ials_stream_pspec(l, mesh, B, A))
                    for l in tree_leaves(streams)]
                 + [(l, shd.ials_aip_param_pspec(l, mesh, A, B))
                    for l in tree_leaves(aip)])
        for leaf, spec in pairs:
            assert len(spec) <= leaf.dim()
            for dim, entry in zip(leaf.shape, spec):
                n = 1
                for a in shd._axes(entry):
                    n *= mesh.shape[a]
                assert dim % n == 0, (domain, kind, A, mesh.shape, spec)


def test_lanes_shard_and_agents_coshard():
    """A = 4 on (4, 2): lanes over data, agents and the stacked AIP over
    model; A = 25 does not divide model = 2: agents replicate and lanes
    absorb model; a trivial mesh replicates everything."""
    mesh = _HostMesh(4, 2)
    assert shd.ials_lane_axes(16, 4, mesh) == (("data",), "model")
    state, _, aip = _trees("traffic", "gru", 4)
    assert shd.ials_state_pspec(state.aip_state, mesh, 4)[:2] == \
        ("data", "model")
    assert shd.ials_aip_param_specs(aip, mesh, 4, 16)["gru"]["wx"][0] == \
        "model"
    assert shd.ials_lane_axes(16, 25, mesh) == (("data", "model"), None)
    state25, _, aip25 = _trees("traffic", "gru", 25)
    assert shd.ials_state_pspec(state25.aip_state, mesh, 25) == \
        (("data", "model"),)
    assert all(s == () for s in shd.spec_leaves(
        shd.ials_aip_param_specs(aip25, mesh, 25, 16), aip25))
    assert all(s == () for s in shd.spec_leaves(
        shd.ials_state_specs(state, _HostMesh(1), 4), state))
    # A = 36 on model = 2: co-sharded, 18 agents a rank
    assert shd.ials_lane_axes(16, 36, mesh) == (("data",), "model")


def test_reference_examples_and_divisibility():
    """The reference's rules on the examples of the port's design notes,
    and the lane factor the sharded engine relies on."""
    m = _HostMesh(4, 2)
    assert shd.ials_lane_axes(16, 25, m) == (("data", "model"), None)
    assert shd.ials_lane_axes(16, 36, m) == (("data",), "model")
    leaf = torch.zeros((128, 16, 36, 2))
    assert shd.ials_stream_pspec(leaf, m, 16, 36) == \
        (None, "data", "model")
    # non-dividing lanes fall back to replication, axis by axis
    assert shd.ials_lane_axes(12, 1, _HostMesh(8)) == ((), None)
    assert shd.ials_lane_axes(6, 1, m) == (("model",), None)
    assert shd.lane_factor(1, m) == 8 and shd.lane_factor(36, m) == 4
    shd.require_lane_sharding(16, 36, m)
    with pytest.raises(ValueError, match="does not divide"):
        shd.require_lane_sharding(6, 36, m)
    assert shd.axis_size(m, "model") == 2 and shd.axis_size(m, "pod") == 1
    pol = {"l1": {"w": torch.zeros(3, 2), "b": torch.zeros(2)}}
    assert shd.spec_leaves(shd.ials_replicated_specs(pol), pol) == [(), ()]


class _RankMesh(_TorchLikeMesh):
    """A torch-like mesh that knows its ranks (``mesh``) and this
    process's coordinate: enough to cut blocks without a process group."""

    def __init__(self, data, model, coord):
        super().__init__(data, model)
        self.mesh = torch.arange(data * model).reshape(data, model)
        self._coord = coord

    def get_coordinate(self):
        return list(self._coord)


def _tiles_once(leaf, spec, data, model):
    """Each rank's block, placed by its coordinates, is that part of the
    leaf; together the blocks cover every element once a replica."""
    sizes = {"data": data, "model": model}
    ranks = [(d, m) for d in range(data) for m in range(model)]
    seen = torch.zeros(leaf.shape, dtype=torch.int32)
    for coord in ranks:
        blk = shd.local_block(leaf, spec, _RankMesh(data, model, coord))
        idx = []
        for dim in range(leaf.dim()):
            e = spec[dim] if dim < len(spec) else None
            i, n = shd._block_index(e, sizes, dict(zip(sizes, coord)))
            size = leaf.shape[dim] // n
            idx.append(slice(i * size, (i + 1) * size))
        assert torch.equal(leaf[tuple(idx)], blk)
        seen[tuple(idx)] += 1
    blocks = 1
    for e in spec:
        blocks *= shd._block_index(e, sizes, {"data": 0, "model": 0})[1]
    assert torch.all(seen == len(ranks) // blocks)


def test_blocks_tile_the_global_state():
    """The blocks of the engine state and the stacked AIP weights tile
    them (replicated dims whole), and ``constrain_ials_state`` accepts a
    rank's blocks and refuses the global tree."""
    state, _, aip = _trees("warehouse", "gru", 4)
    for data, model in ((2, 1), (2, 2), (1, 2), (4, 2)):
        host = _HostMesh(data, model)
        for leaf in tree_leaves(state):
            _tiles_once(leaf, shd.ials_state_pspec(leaf, host, 4), data,
                        model)
        for leaf in tree_leaves(aip):
            _tiles_once(leaf, shd.ials_aip_param_pspec(leaf, host, 4),
                        data, model)
        mesh = _RankMesh(data, model, (0, 0))
        local = shd.shard_ials_state(state, mesh, 4)
        assert shd.constrain_ials_state(local, mesh, 4, B) is local
        with pytest.raises(ValueError, match="not a rank's block"):
            shd.constrain_ials_state(state, mesh, 4, B)
